"""The VMAF gate of the port (``quality/vmaf.py``, the ``min_vmaf`` branch
of ``quality/validators.py``, ``--min-vmaf``) held to the JAX package.

Tolerances: each feature within 1e-4 relative (measured 2.8e-5 at the
coarse scales, where the variances cancel; f32 sums of separable
convolutions in another order: XLA's against PyTorch's on the CPU), the
score within 0.01 of 100, the validator's report (PSNR 1e-3 dB, SSIM
1e-5, the VMAF proxy 0.01, the verdict and notes) equal to JAX's on the
same sampled pairs.
"""

from __future__ import annotations

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from framewright_tpu.quality.validators import QualityValidator as JaxValidator
from framewright_tpu.quality.vmaf import VMAFProxy as JaxVMAF
from framewright_tpu.quality.vmaf import _build_jit, _luma as jax_luma
from framewright_tpu_torch import cli
from framewright_tpu_torch.config import Config
from framewright_tpu_torch.quality.validators import QualityValidator
from framewright_tpu_torch.quality.vmaf import VMAFProxy, VMAFResult, _luma

FEAT_RTOL, SCORE_TOL = 1e-4, 0.01


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _clean(n=3, h=72, w=88, seed=1):
    rng = np.random.default_rng(seed)
    coarse = rng.random((n, h // 8 + 2, w // 8 + 2, 3))
    big = np.repeat(np.repeat(coarse, 8, 1), 8, 2)[:, :h, :w] * 200 + 20
    fine = rng.normal(0, 12, (n, h, w, 3))
    return np.clip(big + fine, 0, 255).astype(np.uint8)


def _noise(x, s=20.0, seed=2):
    return np.clip(x + np.random.default_rng(seed).normal(0, s, x.shape), 0, 255).astype(np.uint8)


def _blur(x):
    f = x.astype(np.float32)
    for ax in (1, 2):
        f = (np.roll(f, 1, ax) + f + np.roll(f, -1, ax)) / 3
    return f.astype(np.uint8)


def _blocks(x, b=8):
    n, h, w, c = x.shape
    f = x[:, : h // b * b, : w // b * b].reshape(n, h // b, b, w // b, b, c).mean(axis=(2, 4))
    out = x.copy()
    out[:, : h // b * b, : w // b * b] = np.repeat(np.repeat(f, b, 1), b, 2).astype(np.uint8)
    return out


DEGRADE = {"pristine": lambda x: x, "noise": _noise, "blur": _blur, "blocking": _blocks,
           "gray": lambda x: x[..., :1].repeat(3, -1)}


@pytest.mark.parametrize("kind", list(DEGRADE))
def test_features_and_score_match_jax(kind):
    ref = _clean()
    dis = DEGRADE[kind](ref)
    import jax.numpy as jnp

    r, d = jnp.asarray(jax_luma(ref)), jnp.asarray(jax_luma(dis))
    want = {k: np.asarray(v) for k, v in
            _build_jit()(r, d, jnp.concatenate([r[:1], r[:-1]], axis=0)).items()}
    proxy = VMAFProxy(device="cpu")
    got = proxy.features(ref, dis)
    for k in ("vif", "dlm", "motion"):
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], rtol=FEAT_RTOL, atol=1e-6, err_msg=k)
    s, js = proxy.score(ref, dis), JaxVMAF().score(ref, dis)
    assert abs(s.score - js.score) <= SCORE_TOL
    np.testing.assert_allclose(s.per_frame, js.per_frame, atol=SCORE_TOL)
    assert s.to_dict().keys() == js.to_dict().keys()
    np.testing.assert_array_equal(_luma(ref), jax_luma(ref))


def test_score_falls_with_each_degradation():
    ref = _clean(2)
    proxy = VMAFProxy(device="cpu")
    clean = proxy.score(ref, ref).score
    for kind in ("noise", "blur", "blocking"):
        assert proxy.score(ref, DEGRADE[kind](ref)).score < clean - 1.0, kind
    assert clean > 90
    assert isinstance(proxy.score(ref[..., 0], ref[..., 0]), VMAFResult)   # luma frames
    with pytest.raises(ValueError, match="shape mismatch"):
        proxy.score(ref, ref[:1])


def _pairs(n=3, seed=4):
    rng = np.random.default_rng(seed)
    ins = _clean(n, 24, 32, seed)
    import torch.nn.functional as F

    x = torch.from_numpy(ins).permute(0, 3, 1, 2).float()
    outs = F.interpolate(x, scale_factor=2, mode="nearest").permute(0, 2, 3, 1).numpy()
    outs = np.clip(outs + rng.normal(0, 3, outs.shape), 0, 255).astype(np.uint8)
    return ins, outs


@pytest.mark.parametrize("gate", [0.0, 1.0, 50.0, 99.0])
def test_validator_with_min_vmaf_matches_jax(gate):
    """The sampled-pairs path with the VMAF gate: the same report (the
    references are the inputs resized bicubically on 0-255, clipped and
    truncated), the score within 0.01, a note under the gate."""
    ins, outs = _pairs()
    reports = []
    for v in (JaxValidator(min_vmaf=gate, sample_every=1),
              QualityValidator(min_vmaf=gate, sample_every=1, device="cpu")):
        for i, o in zip(ins, outs):
            v.observe(i, o)
        reports.append(v.validate())
    want, got = reports
    assert abs(got.vmaf - want.vmaf) <= SCORE_TOL
    assert (got.passed, got.min_vmaf, got.samples) == (want.passed, want.min_vmaf, want.samples)
    assert abs(got.psnr - want.psnr) <= 1e-3 and abs(got.ssim - want.ssim) <= 1e-5
    strip = [n for n in got.notes if not n.startswith("vmaf_proxy")]
    assert strip == [n for n in want.notes if not n.startswith("vmaf_proxy")]
    assert [n[:10] for n in got.notes] == [n[:10] for n in want.notes]
    if gate:
        assert "vmaf_proxy" in got.to_dict() and got.vmaf > 0
    else:
        assert got.vmaf == 0.0 and "vmaf_proxy" not in got.to_dict()
    if gate == 99.0:
        assert not got.passed and got.notes[-1].startswith("vmaf_proxy")


def test_min_vmaf_is_accepted_and_keeps_the_rgb_path(tmp_path, gradient_frame, capsys):
    """``--min-vmaf`` reaches the gate: the restore writes through the RGB
    path (the SR pass computes no stats), and the report has the score."""
    from framewright_tpu_torch.io.y4m import Y4MWriter

    assert Config(min_vmaf=30.0).min_vmaf == 30.0
    src = tmp_path / "c.y4m"
    with Y4MWriter(src, 32, 24, fps=12) as w:
        for t in range(3):
            w.write_frame(gradient_frame(24, 32, t))
    rc = cli.main(["restore", str(src), "-o", str(tmp_path / "o.y4m"), "--model",
                   "FW_fast6_x2", "--device", "cpu", "--project-dir", str(tmp_path / "p"),
                   "--min-vmaf", "1"])
    summary = json.loads(capsys.readouterr().out)
    assert rc == 0 and summary["quality"]["vmaf_proxy"] > 1
    assert summary["quality"]["samples"] == 1                   # one sampled pair
    report = json.loads((tmp_path / "p" / "qa_report.json").read_text())
    assert report["quality"]["vmaf_proxy"] == summary["quality"]["vmaf_proxy"]
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["restore", str(src), "-o", str(tmp_path / "o2.y4m"), "--model",
                       "FW_fast6_x2", "--device", "cpu", "--project-dir",
                       str(tmp_path / "p2")])
    assert rc == 0
