"""URL sources and model downloads of the port, against the JAX package's,
on the CPU: ``io.download``'s argv, a download through a ``yt-dlp``
stand-in script put on a temporary ``PATH`` (the file written where asked,
and the sibling yt-dlp names when it adds an extension), the error
without a downloader, ``restore <URL>`` equal to the restore of the local
file, and ``models download`` from an ``http.server`` on 127.0.0.1
serving a seeded upstream ``.pth`` (then ``models verify`` of it). Nothing
leaves the host."""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import sys
import threading
from functools import partial
from http.server import HTTPServer, SimpleHTTPRequestHandler
from pathlib import Path

import numpy as np
import pytest
import torch

from framewright_tpu import cli as jcli
from framewright_tpu.errors import FramewrightError as JFramewrightError
from framewright_tpu.errors import InputError as JInputError
from framewright_tpu.io import download as jdl
from framewright_tpu.models import registry as jregistry
from framewright_tpu_torch import cli
from framewright_tpu_torch.errors import FramewrightError, InputError
from framewright_tpu_torch.io import download as dl
from framewright_tpu_torch.io.y4m import Y4MWriter
from framewright_tpu_torch.models import registry, upstream_ref

# a yt-dlp stand-in: copies $FW_STANDIN_SRC to the -o path (or to <-o>.y4m
# with $FW_STANDIN_SUFFIX), records its argv, exits $FW_STANDIN_RC
STANDIN = """#!{python}
import os, shutil, sys
argv = sys.argv[1:]
with open(os.environ["FW_STANDIN_LOG"], "a") as f:
    f.write(" ".join(argv) + "\\n")
rc = int(os.environ.get("FW_STANDIN_RC", "0"))
if rc:
    sys.stderr.write("ERROR: stand-in refused the URL\\n")
    sys.exit(rc)
out = argv[argv.index("-o") + 1] + os.environ.get("FW_STANDIN_SUFFIX", "")
shutil.copyfile(os.environ["FW_STANDIN_SRC"], out)
"""


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _clip(path: Path, n: int = 3, h: int = 24, w: int = 32) -> Path:
    rng = np.random.default_rng(3)
    y, x = np.mgrid[0:h, 0:w]
    with Y4MWriter(path, w, h, fps=12) as wr:
        for t in range(n):
            g = 127 + 100 * np.sin(x / 5 + y / 7 + rng.random() * 6 + t * 0.3)
            wr.write_frame(np.clip(np.stack([g, g * 0.9 + 10, g * 0.8 + 20], -1), 0, 255)
                           .astype(np.uint8))
    return path


@pytest.fixture()
def standin(tmp_path, monkeypatch):
    """``yt-dlp`` on a PATH of its own; the clip it serves; its argv log."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    tool = bindir / "yt-dlp"
    tool.write_text(STANDIN.format(python=sys.executable))
    tool.chmod(0o755)
    src = _clip(tmp_path / "served.y4m")
    monkeypatch.setenv("PATH", str(bindir))
    monkeypatch.setenv("FW_STANDIN_SRC", str(src))
    monkeypatch.setenv("FW_STANDIN_LOG", str(tmp_path / "argv.log"))
    return tool, src, tmp_path / "argv.log"


@pytest.mark.parametrize("kw", [{}, {"rate_limit": "2M"}, {"playlist": True},
                                {"format_spec": "best[height<=720]"}])
def test_build_command_equals_jax(kw):
    args = ("yt-dlp", "https://example.com/v?id=1", Path("/tmp/o.mp4"))
    cmd = dl.build_command(*args, **kw)
    assert cmd == jdl.build_command(*args, **kw)
    assert cmd[0] == "yt-dlp" and cmd[-1] == "https://example.com/v?id=1"
    assert ("--no-playlist" in cmd) is not kw.get("playlist", False)
    assert ("--limit-rate" in cmd) is bool(kw.get("rate_limit"))


@pytest.mark.parametrize("url", ["file:///etc/passwd", "ftp://h/x", "https://", "http://h/\x00"])
def test_build_command_rejects_bad_urls_as_jax(url):
    with pytest.raises(InputError):
        dl.build_command("yt-dlp", url, Path("/tmp/o"))
    with pytest.raises(JInputError):
        jdl.build_command("yt-dlp", url, Path("/tmp/o"))


def test_download_without_binary_is_a_clean_error(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    assert dl.find_downloader() is None is jdl.find_downloader()
    with pytest.raises(FramewrightError, match="yt-dlp"):
        dl.download_video("https://example.com/v", tmp_path / "o.mp4")
    with pytest.raises(JFramewrightError, match="yt-dlp"):
        jdl.download_video("https://example.com/v", tmp_path / "o.mp4")


@pytest.mark.parametrize("suffix", ["", ".y4m"], ids=["as-asked", "sibling"])
def test_download_through_the_standin_equals_jax(tmp_path, standin, monkeypatch, suffix):
    tool, src, log = standin
    monkeypatch.setenv("FW_STANDIN_SUFFIX", suffix)
    assert dl.find_downloader() == jdl.find_downloader() == str(tool)
    got = dl.download_video("https://example.com/clip.mp4", tmp_path / "p" / "source.mp4")
    want = jdl.download_video("https://example.com/clip.mp4", tmp_path / "j" / "source.mp4")
    assert got.name == want.name == "source.mp4" + suffix
    assert got.read_bytes() == want.read_bytes() == src.read_bytes()
    lines = log.read_text().splitlines()
    assert lines[0].replace("/p/", "/j/") == lines[1]


def test_download_failure_names_the_exit_and_stderr(tmp_path, standin, monkeypatch):
    monkeypatch.setenv("FW_STANDIN_RC", "2")
    for mod, err in ((dl, FramewrightError), (jdl, JFramewrightError)):
        with pytest.raises(err, match=r"download failed \(2\): ERROR: stand-in refused"):
            mod.download_video("https://example.com/v", tmp_path / "o.mp4")


def test_restore_of_a_url_equals_the_restore_of_the_local_file(tmp_path, standin, monkeypatch,
                                                              capsys):
    """``restore https://example.com/clip.mp4``: the stand-in writes the
    clip's Y4M bytes to ``<project>/downloads/source.mp4.y4m`` (yt-dlp's
    sibling name), and the restore of it equals the restore of the local
    file byte for byte."""
    _, src, log = standin
    monkeypatch.setenv("FW_STANDIN_SUFFIX", ".y4m")
    flags = ["--model", "FW_fastvgg_x2", "--device", "cpu", "--no-checkpoint"]
    assert cli.main(["restore", "https://example.com/clip.mp4", "-o", str(tmp_path / "u.y4m"),
                     "--project-dir", str(tmp_path / "pu"), *flags]) == 0
    url_summary = json.loads(capsys.readouterr().out)
    assert cli.main(["restore", str(src), "-o", str(tmp_path / "l.y4m"),
                     "--project-dir", str(tmp_path / "pl"), *flags]) == 0
    local_summary = json.loads(capsys.readouterr().out)
    assert (tmp_path / "u.y4m").read_bytes() == (tmp_path / "l.y4m").read_bytes()
    assert url_summary["frames"] == local_summary["frames"] == 3
    assert (tmp_path / "pu" / "downloads" / "source.mp4.y4m").read_bytes() == src.read_bytes()
    assert log.read_text().split()[-1] == "https://example.com/clip.mp4"


def test_restore_of_a_url_without_a_downloader_fails_as_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    argv = ["restore", "https://example.com/clip.mp4", "-o", str(tmp_path / "o.y4m"),
            "--project-dir", str(tmp_path / "p"), "--device", "cpu"]
    rc, out, err = run(cli.main, argv)
    jrc, jout, jerr = run(jcli.main, argv)
    assert rc == jrc == 1 and out == jout == ""
    assert err.strip() == jerr.strip() and "No downloader found" in err
    assert not (tmp_path / "o.y4m").exists()


class _Quiet(SimpleHTTPRequestHandler):
    def log_message(self, *args):
        pass


@pytest.fixture()
def weights_server(tmp_path):
    """An http.server on 127.0.0.1 serving ``tmp_path/served``."""
    root = tmp_path / "served"
    root.mkdir()
    srv = HTTPServer(("127.0.0.1", 0), partial(_Quiet, directory=str(root)))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield root, f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    t.join()
    srv.server_close()


def test_models_download_then_verify(tmp_path, weights_server, monkeypatch):
    """``models download realesr-animevideov3`` with the row's URL pointed at
    a local server of a seeded upstream ``.pth``: JAX's lines and rc, the
    file's bytes, then ``models verify`` of it PASS with rc 0."""
    root, base = weights_server
    name = "realesr-animevideov3"
    sd = upstream_ref.seeded_state_dict(registry.MODEL_SPECS[name], seed=11)
    torch.save(sd, root / f"{name}.pth")
    url = f"{base}/{name}.pth"
    for reg in (registry, jregistry):
        monkeypatch.setitem(reg.MODEL_SPECS, name, dataclasses.replace(reg.MODEL_SPECS[name],
                                                                       url=url))
    results = []
    for main, wdir in ((jcli.main, tmp_path / "jw"), (cli.main, tmp_path / "pw")):
        monkeypatch.setenv("FRAMEWRIGHT_WEIGHTS_DIR", str(wdir))
        rc, out, err = run(main, ["models", "download", name])
        results.append((rc, out.replace(str(wdir), "W"), err.replace(str(wdir), "W")))
    assert results[1] == results[0]
    rc, out, err = results[1]
    assert rc == 0 and out == f"W/{name}.pth\n" and err == f"downloading {url} -> W/{name}.pth\n"
    got = tmp_path / "pw" / f"{name}.pth"
    assert got.read_bytes() == (root / f"{name}.pth").read_bytes()
    rc, out, err = run(cli.main, ["models", "verify", name, "--device", "cpu"])
    lines = out.splitlines()
    assert rc == 0 and err == "" and lines[-1].endswith("[PASS]"), (out, err)
    assert lines[0].startswith("manifest: 53 keys expected, 0 missing")


def test_models_download_of_an_unknown_name_fails(tmp_path, monkeypatch):
    monkeypatch.setenv("FRAMEWRIGHT_WEIGHTS_DIR", str(tmp_path / "w"))
    rc, out, err = run(cli.main, ["models", "download", "NoSuchModel"])
    assert rc == 1 and out == "" and "Unknown model 'NoSuchModel'" in err
    assert not (tmp_path / "w" / "NoSuchModel.pth").exists()
