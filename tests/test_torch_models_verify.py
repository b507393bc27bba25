"""``models verify`` (A12b): the port's verb against JAX's on seeded
``.pth`` files, on the CPU.

Each file is drawn by ``models.upstream_ref.seeded_state_dict`` (the
upstream's own init, from a seeded ``torch.Generator``) and run through
JAX's ``cmd_models`` verify and the port's: the manifest and port lines
equal, both parity lines PASS at the 45 dB gate, the same return code.
The RRDB is FW_fast6_x2 (6 blocks, no manifest): JAX ports a row at the
row's own block count, so a shallower RRDB file fails JAX's port.
"""

from __future__ import annotations

import contextlib
import io
from pathlib import Path

import numpy as np
import pytest
import torch

from framewright_tpu import cli as jcli
from framewright_tpu.models import torch_ref
from framewright_tpu_torch import cli
from framewright_tpu_torch.models import registry, upstream_ref


def run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue().splitlines(), err.getvalue()


def verify(name: str, path: Path):
    """(port, jax) results of ``models verify name --path path``."""
    args = ["models", "verify", name, "--path", str(path)]
    return run(cli.main, args + ["--device", "cpu"]), run(jcli.main, args)


def seeded(tmp_path: Path, name: str, edit=None) -> Path:
    sd = upstream_ref.seeded_state_dict(registry.MODEL_SPECS[name], seed=5)
    if edit is not None:
        edit(sd)
    path = tmp_path / f"{name}.pth"
    torch.save(sd, path)
    return path


@pytest.mark.parametrize("name", ["realesr-animevideov3", "FW_fast6_x2"])
def test_verify_passes_with_jax_lines(tmp_path, name):
    (rc, lines, err), (jrc, jlines, jerr) = verify(name, seeded(tmp_path, name))
    assert rc == jrc == 0 and err == jerr == ""
    assert lines[:-1] == jlines[:-1]           # manifest (or its skip) and port lines
    assert lines[0].startswith("manifest: 53 keys" if name.startswith("realesr")
                               else "no manifest recorded")
    for line in (lines[-1], jlines[-1]):
        assert line.startswith("parity vs torch: ") and line.endswith("[PASS]")
    assert float(lines[-1].split()[3]) >= 45.0


def _drop(key):
    return lambda sd: sd.pop(key)


def _narrow(key):
    def edit(sd):
        sd[key] = sd[key][:, :32].clone()
    return edit


@pytest.mark.parametrize("name,edit,what", [
    ("realesr-animevideov3", _drop("body.10.bias"), "missing"),
    ("FW_fast6_x2", _drop("body.0.rdb1.conv2.weight"), "missing"),
    ("realesr-animevideov3", _narrow("body.4.weight"), "shape"),
], ids=["vgg-missing", "rrdb-missing", "vgg-shape"])
def test_broken_files_fail_as_jax(tmp_path, name, edit, what):
    """A missing key: the manifest's count and ``! key`` line, then JAX's
    port error, rc 1. A bad shape: the manifest's mismatch, the port line,
    then the parity forward skipped (each package names its own reason),
    rc 1."""
    (rc, lines, err), (jrc, jlines, jerr) = verify(name, seeded(tmp_path, name, edit))
    assert rc == jrc == 1
    if what == "missing":
        assert lines == jlines and err == jerr and err.startswith("error: Missing weight ")
    else:
        assert lines[:-1] == jlines[:-1] and "1 shape mismatches" in lines[0]
        assert lines[-1].startswith("parity: skipped (") and jlines[-1].startswith(
            "parity: skipped (")


def test_family_without_a_reference_prints_jax_skip_line(tmp_path):
    """BasicVSR: ported, then JAX's skip line naming JAX's family."""
    tm = torch_ref.build_basicvsr()
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in tm.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.02)
    path = tmp_path / "BasicVSR.pth"
    torch.save(tm.state_dict(), path)
    (rc, lines, err), (jrc, jlines, jerr) = verify("BasicVSR", path)
    assert rc == jrc == 0 and lines == jlines
    assert lines[-1] == "parity: skipped (no torch reference for family 'vsr')"


def test_missing_checkpoint_and_refused_download(tmp_path, monkeypatch):
    """A missing checkpoint, and a download the server refuses: the row's
    URL pointed at a closed port on 127.0.0.1 in both packages, JAX's lines
    and return code (the download that succeeds:
    tests/test_torch_download.py)."""
    import dataclasses
    import socket

    from framewright_tpu.models import registry as jregistry

    (rc, lines, err), (jrc, jlines, jerr) = verify("realesr-animevideov3",
                                                   tmp_path / "none.pth")
    assert rc == jrc == 1 and lines == jlines == [] and err == jerr
    assert err.startswith("error: checkpoint not found: ")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        url = f"http://127.0.0.1:{s.getsockname()[1]}/realesr-animevideov3.pth"
    for reg in (registry, jregistry):
        monkeypatch.setitem(reg.MODEL_SPECS, "realesr-animevideov3", dataclasses.replace(
            reg.MODEL_SPECS["realesr-animevideov3"], url=url))
    monkeypatch.setenv("FRAMEWRIGHT_WEIGHTS_DIR", str(tmp_path / "w"))
    argv = ["models", "download", "realesr-animevideov3"]
    assert run(cli.main, argv) == run(jcli.main, argv)
    rc, out, err = run(cli.main, argv)
    assert rc == 1 and out == [] and "error: download failed" in err and url in err


def test_seeded_draw_follows_the_upstream_init():
    """basicsr's RDB convs: Kaiming-normal x 0.1 with zero biases; the
    other convs nn.Conv2d's own bounds; PReLU 0.25; the same seed the same
    bytes."""
    spec = registry.MODEL_SPECS["FW_fast6_x2"]
    a = upstream_ref.seeded_state_dict(spec, seed=1)
    b = upstream_ref.seeded_state_dict(spec, seed=1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = a["body.0.rdb1.conv1.weight"]
    assert float(a["body.0.rdb1.conv1.bias"].abs().max()) == 0.0
    assert abs(float(w.std()) - 0.1 * np.sqrt(2.0 / w[0].numel())) < 0.002
    bound = 1.0 / np.sqrt(a["conv_first.weight"][0].numel())
    assert float(a["conv_first.weight"].abs().max()) <= bound
    vgg = upstream_ref.seeded_state_dict(registry.MODEL_SPECS["realesr-animevideov3"], 1)
    assert torch.all(vgg["body.1.weight"] == 0.25)


@pytest.mark.parametrize("name", ["FW_nafnet_dn", "restormer"])
def test_verify_the_denoisers_nets_which_jax_cannot(tmp_path, name):
    """The denoiser's NAFNet and Restormer: JAX's verify has no port for
    them (``FW_nafnet_dn``'s row has no ``port_fn``; ``restormer`` is no
    JAX row); the port's ports and passes them."""
    sd = upstream_ref.seeded_state_dict(registry.AUX_SPECS[name], seed=6)
    path = tmp_path / f"{name}.pth"
    torch.save(sd, path)
    rc, lines, err = run(cli.main, ["models", "verify", name, "--path", str(path),
                                    "--device", "cpu"])
    assert rc == 0 and err == "" and lines[0].startswith("no manifest recorded")
    assert lines[1].startswith("port: OK (") and lines[-1].endswith("[PASS]")
    jargs = ["models", "verify", name, "--path", str(path)]
    if name == "restormer":
        jrc, _, jerr = run(jcli.main, jargs)
        assert jrc == 1 and "Unknown model 'restormer'" in jerr
    else:
        with pytest.raises(TypeError):          # JAX calls the row's port_fn, None
            run(jcli.main, jargs)
