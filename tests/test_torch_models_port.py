"""``models port`` and ``models verify`` for the rows JAX ports beyond SR
(CodeFormer, GFPGANv1.4, big-lama, rife-v4.6, raft-things,
RetinaFace_mnet025), against the JAX package's verbs on the CPU.

Each upstream file is drawn from the JAX package's ``torch_ref.build_*``
under ``torch.manual_seed`` and saved as ``.pth``: CodeFormer, IFNet (its
``blocks.{b}`` named ``block{b}``, as Practical-RIFE's ``flownet.pkl``
and the manifest name them), RAFT and RetinaFace at their published
widths, GFPGAN at the builder's small default, LaMa at narrow widths (ngf 16, 2 blocks, ratio 0.75) with its
BatchNorms drawn away from the identity (so that the FourierUnit's
permuted BN reaches the parity). Both packages' ``models port`` write
``<weights dir>/<name>.npz``; the two files are equal leaf for leaf
(``np.array_equal``, same keys and dtypes). JAX's export compresses its
``.npz``; the test lets it write the same leaves uncompressed, which is
the only change to JAX's path, so that CodeFormer's 94 M parameters take
a second and not twenty. The port's loaders (``load_aux``;
the inpainter for ``big-lama``) read the port's file into what they read
from JAX's. Both ``models verify`` print the same lines and return the
same code (LaMa's parity line: PASS at >= 45 dB in each, its PSNR each
package's own).
"""

from __future__ import annotations

import contextlib
import io
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from framewright_tpu import cli as jcli
from framewright_tpu.models import torch_ref
from framewright_tpu_torch import cli
from framewright_tpu_torch.models import registry, upstream_ref

NAMES = ["CodeFormer", "GFPGANv1.4", "big-lama", "rife-v4.6", "raft-things",
         "RetinaFace_mnet025"]
LAMA_ARCH = dict(ngf=16, n_down=3, n_blocks=2, ratio=0.75)


def _draw(name: str) -> dict:
    torch.manual_seed(NAMES.index(name) + 3)
    if name == "CodeFormer":
        net = torch_ref.build_codeformer()
    elif name == "GFPGANv1.4":
        net = torch_ref.build_gfpgan()
    elif name == "big-lama":
        net = torch_ref.build_lama(**LAMA_ARCH)
        g = torch.Generator().manual_seed(9)
        with torch.no_grad():
            for mod in net.modules():
                if isinstance(mod, torch.nn.BatchNorm2d):
                    n = mod.num_features
                    mod.weight.copy_(1.0 + 0.2 * torch.randn(n, generator=g))
                    mod.bias.copy_(0.1 * torch.randn(n, generator=g))
                    mod.running_mean.copy_(0.1 * torch.randn(n, generator=g))
                    mod.running_var.copy_(1.0 + 0.5 * torch.rand(n, generator=g))
    elif name == "rife-v4.6":        # Practical-RIFE names its blocks block0 .. block3
        net = torch_ref.build_ifnet()
        return {re.sub(r"^blocks\.(\d+)\.", r"block\1.", k): v.detach().clone()
                for k, v in net.state_dict().items()}
    elif name == "raft-things":
        net = torch_ref.build_raft()
    else:
        net = torch_ref.build_retinaface()
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


@pytest.fixture(scope="module")
def upstream(tmp_path_factory):
    """name -> the seeded upstream ``.pth`` (RIFE also as ``module.``-
    prefixed ``flownet.pkl``, as DataParallel saves it)."""
    root = tmp_path_factory.mktemp("upstream")
    files = {}
    for name in NAMES:
        sd = _draw(name)
        files[name] = root / f"{name}.pth"
        torch.save(sd, files[name])
        if name == "rife-v4.6":
            files["flownet.pkl"] = root / "flownet.pkl"
            torch.save({f"module.{k}": v for k, v in sd.items()}, files["flownet.pkl"])
    return files


def run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue().splitlines(), err.getvalue()


@pytest.fixture
def ported(upstream, tmp_path, monkeypatch):
    """port(name, path) -> (port's .npz, JAX's .npz), each package's
    ``models port`` into a weights dir of its own."""
    monkeypatch.setattr(np, "savez_compressed", np.savez)

    def port(name, path):
        out = {}
        for pkg, main in (("port", cli.main), ("jax", jcli.main)):
            wdir = tmp_path / pkg
            monkeypatch.setenv("FRAMEWRIGHT_WEIGHTS_DIR", str(wdir))
            rc, lines, err = run(main, ["models", "port", name, "--path", str(path)])
            assert (rc, err) == (0, ""), err
            assert lines == [str(wdir / f"{name}.npz")]
            out[pkg] = wdir / f"{name}.npz"
        return out["port"], out["jax"]

    return port


def _leaves_equal(a: Path, b: Path) -> None:
    with np.load(a) as fa, np.load(b) as fb:
        assert sorted(fa.files) == sorted(fb.files)
        for k in fa.files:
            assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
            assert np.array_equal(fa[k], fb[k]), k


@pytest.mark.parametrize("name", NAMES)
def test_models_port_writes_jax_npz(upstream, ported, name):
    mine, jax_npz = ported(name, upstream[name])
    _leaves_equal(mine, jax_npz)


def test_rife_dataparallel_file_ports_the_same(upstream, ported, tmp_path):
    """``flownet.pkl`` (``module.`` keys) ports to the unprefixed file's
    leaves in both packages."""
    mine, jax_npz = ported("rife-v4.6", upstream["flownet.pkl"])
    _leaves_equal(mine, jax_npz)
    plain = tmp_path / "plain.npz"
    registry.write_npz(registry.port_checkpoint("rife-v4.6", upstream["rife-v4.6"]), plain)
    _leaves_equal(mine, plain)


def _tree_equal(a, b) -> None:
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _tree_equal(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", NAMES)
def test_loader_reads_the_ported_file(upstream, ported, name):
    """The port's loader reads its own ``models port`` file into what it
    reads from JAX's: ``load_aux`` (spec and state dict or tree), and the
    inpainter's LaMa tree and widths."""
    mine, jax_npz = ported(name, upstream[name])
    if name == "big-lama":
        from framewright_tpu_torch.processors.inpaint import InpaintConfig, WatermarkRemover

        got = []
        for npz in (mine, jax_npz):
            w = WatermarkRemover(InpaintConfig(weights_dir=str(npz.parent), device="cpu"))
            w.setup()
            got.append((w._arch, w._params))
        assert got[0][0] == got[1][0]
        assert got[0][0].n_blocks == LAMA_ARCH["n_blocks"]
        _tree_equal(got[0][1], got[1][1])
        return
    a = registry.load_aux(name, mine.parent)
    b = registry.load_aux(name, jax_npz.parent)
    assert a[0] == b[0]
    _tree_equal(a[1], b[1])


def verify(name: str, path: Path):
    args = ["models", "verify", name, "--path", str(path)]
    return run(cli.main, args + ["--device", "cpu"]), run(jcli.main, args)


@pytest.mark.parametrize("name", NAMES)
def test_models_verify_prints_jax_lines(upstream, name):
    """The manifest line (or its skip: RetinaFace's manifest is recorded
    in lower case), ``port: OK``, then JAX's skip line naming JAX's family
    or, for LaMa, the parity line PASS in both; JAX's return code (GFPGAN
    and LaMa are drawn narrower than the published files: their
    manifests' missing keys and shapes give rc 1 in both)."""
    (rc, lines, err), (jrc, jlines, jerr) = verify(name, upstream[name])
    assert rc == jrc and err == jerr == ""
    assert rc == (1 if name in ("GFPGANv1.4", "big-lama") else 0)
    if name == "big-lama":
        assert lines[:-1] == jlines[:-1]
        for line in (lines[-1], jlines[-1]):
            assert line.startswith("parity vs torch: ") and line.endswith("[PASS]")
            assert float(line.split()[3]) >= 45.0
        return
    assert lines == jlines
    assert lines[-2].startswith("port: OK (")
    family = {"CodeFormer": "face", "GFPGANv1.4": "face", "rife-v4.6": "ifnet",
              "raft-things": "flow", "RetinaFace_mnet025": "detector"}[name]
    assert lines[-1] == f"parity: skipped (no torch reference for family '{family}')"
    if name == "RetinaFace_mnet025":
        assert lines[0].startswith("no manifest recorded")
    else:
        assert lines[0].startswith("manifest: ")


def test_published_width_lama_verifies_on_its_manifest(tmp_path):
    """``seeded_state_dict``'s inpaint draw is Big-LaMa at the row's
    widths (18 blocks, ratio 0.75): the manifest finds every key, the
    parity passes, rc 0 (what the card runs without JAX)."""
    spec = registry.AUX_SPECS["big-lama"]
    sd = upstream_ref.seeded_state_dict(spec, seed=3)
    path = tmp_path / "big-lama.pth"
    torch.save(sd, path)
    rc, lines, err = run(cli.main, ["models", "verify", "big-lama", "--path", str(path),
                                    "--device", "cpu"])
    assert (rc, err) == (0, "")
    assert lines[0].endswith("0 missing, 0 unexpected, 0 shape mismatches")
    assert lines[1] == "port: OK (51.06M params)"
    assert lines[-1].endswith("[PASS]") and float(lines[-1].split()[3]) >= 45.0


def test_a_missing_conv_fails_as_jax(upstream, tmp_path):
    """A GFPGAN file without one conv weight: the manifest's missing
    line, then JAX's port error, rc 1, in both packages."""
    sd = torch.load(upstream["GFPGANv1.4"], weights_only=True)
    sd.pop("conv_body_up.0.conv2.weight")
    path = tmp_path / "broken.pth"
    torch.save(sd, path)
    (rc, lines, err), (jrc, jlines, jerr) = verify("GFPGANv1.4", path)
    assert rc == jrc == 1 and lines == jlines and err == jerr
    assert err.startswith("error: Missing weight 'conv_body_up.0.conv2.weight'")


def test_only_rows_without_a_published_checkpoint_refuse(tmp_path):
    """``TVSR_x4`` and ``DiffusionSR_x4`` (JAX's ``port_fn`` is None)
    still raise, with the reason; ``models list`` prints JAX's big-lama
    line."""
    path = tmp_path / "x.pth"
    torch.save({"w": torch.zeros(1)}, path)
    for name in ("TVSR_x4", "DiffusionSR_x4"):
        rc, _, err = run(cli.main, ["models", "port", name, "--path", str(path)])
        assert rc == 1 and err == f"error: {name} has no published checkpoint to port\n"
    _, lines, _ = run(cli.main, ["models", "list"])
    _, jlines, _ = run(jcli.main, ["models", "list"])
    mine = [ln for ln in lines if ln.startswith("big-lama ")]
    assert mine and mine == [ln for ln in jlines if ln.startswith("big-lama ")]
