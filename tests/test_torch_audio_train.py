"""The audio mask nets' training (``models/audio_net.py``) on the CPU
against the JAX package: the synthetic audio and the band-power examples
bit for bit; ``train_mask_net`` and ``train_separator`` over 40 steps
from the same seed (after k steps the parameters' mean |delta| <= 0.01 lr
k and max |delta| <= 2 lr k); the GRU's hidden bias still zero; the
written checkpoint read by JAX's ``load_params``."""

import builtins

import numpy as np
import pytest
import torch

from framewright_tpu.models import audio_net as ja
from framewright_tpu_torch.errors import DeviceError
from framewright_tpu_torch.models import audio_net as pa

STEPS, LR = 40, 2e-3


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_synthetic_audio_is_jax_bit_for_bit():
    ra, rb = np.random.default_rng(21), np.random.default_rng(21)
    for name in ("synth_clean", "synth_noise", "synth_music"):
        want, got = getattr(ja, name)(ra, 24000, 48000), getattr(pa, name)(rb, 24000, 48000)
        assert want.dtype == got.dtype == np.float32 and np.array_equal(want, got), name
    for name in ("make_batch", "make_batch_sep"):
        for want, got in zip(getattr(ja, name)(ra), getattr(pa, name)(rb)):
            assert got.dtype == np.float32 and np.array_equal(want, got), name
    assert ra.random() == rb.random()


def _train_both(monkeypatch, name):
    seen = []
    monkeypatch.setattr(ja, "float", lambda x: seen.append(float(np.asarray(x)))
                        or builtins.float(x), raising=False)
    want = getattr(ja, name)(steps=STEPS, seed=0, lr=LR, log_every=1)
    report = {}
    got = getattr(pa, name)(steps=STEPS, seed=0, lr=LR, device="cpu", report=report)
    assert sorted(got) == sorted(want) and len(seen) == len(report["losses"]) == STEPS
    d = np.concatenate([np.abs(want[k] - got[k]).ravel() for k in want])
    assert d.mean() <= 0.01 * LR * STEPS and d.max() <= 2 * LR * STEPS, (d.mean(), d.max())
    return np.asarray(seen), np.asarray(report["losses"])


def test_train_mask_net_matches_jax(monkeypatch):
    """Every step's loss within 1e-4 relative of JAX's."""
    want, got = _train_both(monkeypatch, "train_mask_net")
    assert np.all(np.abs(got - want) <= 1e-4 * np.abs(want)), np.abs(got / want - 1).max()


def test_train_separator_matches_jax(monkeypatch):
    """Every step's loss within 1e-3 relative of JAX's, not 1e-4: the first
    (the same parameters) differs by 1.7e-6, the later ones drift up to
    2.4e-4 after step 18. XLA's f32 log is not correctly rounded (it
    differs from the correctly rounded log on ~2% of a batch's band
    powers, where the port's is), and the per-band normalisation divides
    those ulps by deviations near 1e-3 on the bands of nearly constant
    music power; Adam at a constant 2e-3 carries the difference on
    (ROADMAP, section C caveats). The parameters meet the bounds."""
    want, got = _train_both(monkeypatch, "train_separator")
    rel = np.abs(got - want) / np.abs(want)
    assert rel.max() <= 1e-3, rel


def test_gru_hidden_bias_stays_zero_and_checkpoint_reads_in_jax(tmp_path):
    rng = np.random.default_rng(1)
    net = pa.fit(pa.init_params(0), lambda: pa.make_batch(rng), True, 3, LR, device="cpu")
    assert torch.count_nonzero(net.gru.bias_hh_l0) == 0
    assert not net.gru.bias_hh_l0.requires_grad and not net.gru.training
    params = net.params()
    assert not np.array_equal(params["gru_wi"], pa.init_params(0)["gru_wi"])
    path = pa.save_params(params, tmp_path / "mask.npz")
    back = ja.load_params(path)
    assert sorted(back) == sorted(params)
    assert all(np.array_equal(back[k], params[k]) for k in params)
    # the trained net's forward is the MaskNet of its tree
    x = torch.from_numpy(pa.make_batch(np.random.default_rng(2))[0])
    assert torch.equal(net(x), pa.MaskNet(params, "cpu")(x))


def test_trainers_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError):
        pa.train_mask_net(steps=1)
