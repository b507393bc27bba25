"""Face restoration in the port (``processors/faces``, ``models/gfpgan``,
``models/retinaface``) against the JAX package: the skin-chroma
detector's boxes, RetinaFace on the JAX draw ``retinaface.init``, the
host NMS, GFPGAN at the JAX face restorer's 64-pixel stand-in
(``gfpgan.init(PRNGKey(6), ...)``, the weights a JAX restore without a
checkpoint runs, carried across as ``GFPGANv1.4.npz``), ``restore_frame``
with the ``sr`` and ``gfpgan`` backends, the weights directory reaching
the face restorer (the JAX restorer drops it), and the refusals."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import framewright_tpu.processors.faces as jfaces
import framewright_tpu.restorer as jrestorer
from framewright_tpu.errors import StageError
from framewright_tpu.models import gfpgan as jgfpgan
from framewright_tpu.models import retinaface as jretina
from framewright_tpu.models.torch_port import export_npz
from framewright_tpu_torch import cli
from framewright_tpu_torch.config import Config
from framewright_tpu_torch.errors import ConfigError, InputError
from framewright_tpu_torch.models import registry
from framewright_tpu_torch.models.gfpgan import GFPGAN, GFPGANConfig, config_from_params
from framewright_tpu_torch.models.retinaface import RetinaFace, RetinaFaceConfig, nms_host
from framewright_tpu_torch.models.srvgg import SRVGGConfig
from framewright_tpu_torch.processors import faces
from framewright_tpu_torch.restorer import VideoRestorer

TINY = dict(out_size=64, num_style_feat=64, channel_multiplier=1, num_mlp=2, narrow=0.25)
LSB_SHARE = 1e-3        # uint8: within 1 LSB on at most 0.1% of the values


@pytest.fixture(autouse=True)
def _few_threads(monkeypatch, tmp_path):
    # the JAX package's default weights directory: empty (no RetinaFace)
    monkeypatch.setenv("FRAMEWRIGHT_WEIGHTS_DIR", str(tmp_path / "default_weights"))
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def tiny_gfpgan():
    return _np_tree(jgfpgan.init(jax.random.PRNGKey(6), jgfpgan.GFPGANConfig(**TINY)))


@pytest.fixture(scope="module")
def retina_params():
    return _np_tree(jretina.init(jax.random.PRNGKey(3)))


def face_frame(seed: int, h: int = 96, w: int = 128, blobs: int = 2) -> np.ndarray:
    """Seeded grey texture with ``blobs`` textured skin-coloured regions
    (and a small skin speck the opening removes)."""
    rng = np.random.default_rng(seed)
    f = rng.integers(20, 90, (h, w, 3)).astype(np.int16)
    for k in range(blobs):
        bh, bw = rng.integers(18, 30), rng.integers(14, 24)
        y0, x0 = rng.integers(0, h - bh), rng.integers(0, w - bw)
        skin = np.array([205, 150, 125]) + rng.integers(-12, 12, (bh, bw, 3))
        f[y0:y0 + bh, x0:x0 + bw] = skin
    f[2:4, 2:4] = (205, 150, 125)
    return np.clip(f, 0, 255).astype(np.uint8)


def _within_one_lsb(got, want):
    d = np.abs(np.asarray(got, np.int16) - np.asarray(want, np.int16))
    assert d.max() <= 1 and (d > 0).mean() <= LSB_SHARE, (d.max(), (d > 0).mean())


# -- detectors ----------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_skin_detector_boxes_equal_jax(seed):
    frame = face_frame(seed)
    got = faces.FaceDetector().detect(frame)
    want = jfaces.FaceDetector().detect(frame)
    assert [b.__dict__ for b in got] == [b.__dict__ for b in want]
    assert got, "the seeded frame has skin regions"
    assert faces.FaceDetector().detect(np.zeros((40, 40, 3), np.uint8)) == []


def test_retinaface_scores_and_boxes_equal_jax(retina_params):
    """Scores and decoded boxes against JAX ``retinaface.apply`` within
    5e-3 (the JAX package's bound against its torch reference,
    tests/test_retinaface.py); landmarks too."""
    net = RetinaFace.from_state_dict(RetinaFaceConfig(),
                                     registry.from_jax_params(retina_params, torch.float32), "cpu")
    x = np.random.default_rng(0).random((2, 64, 96, 3), dtype=np.float32)
    with torch.no_grad():
        s, b, l = (t.numpy() for t in net.apply(torch.from_numpy(x)))
    js, jb, jl = (np.asarray(t) for t in jretina.apply(retina_params, x))
    assert s.shape == js.shape == (2, 252) and b.shape == jb.shape
    for got, want in ((s, js), (b, jb), (l, jl)):
        assert np.abs(got - want).max() < 5e-3


def test_nms_host_equals_jax():
    rng = np.random.default_rng(4)
    xy = rng.random((300, 2)) * 0.8
    boxes = np.concatenate([xy, xy + 0.05 + rng.random((300, 2)) * 0.2], 1).astype(np.float32)
    scores = rng.random(300).astype(np.float32)
    for iou, th, k in ((0.4, 0.5, 256), (0.2, 0.3, 50), (0.9, 0.99, 10)):
        assert nms_host(scores, boxes, iou, th, k) == jretina.nms_host(scores, boxes, iou, th, k)


def test_make_detector_and_retinaface_detect_equal_jax(tmp_path, retina_params):
    """``auto``: the skin detector without ``RetinaFace_mnet025.npz``,
    RetinaFace with it; its boxes against the JAX detector's on the same
    weights within a pixel (the decoded floats are truncated to pixels)."""
    assert isinstance(faces.make_detector("auto", str(tmp_path), "cpu"), faces.FaceDetector)
    with pytest.raises(InputError, match="RetinaFace_mnet025"):
        faces.make_detector("retinaface", str(tmp_path), "cpu")
    export_npz(retina_params, tmp_path / "RetinaFace_mnet025.npz")
    det = faces.make_detector("auto", str(tmp_path), "cpu")
    assert isinstance(det, faces.RetinaFaceDetector)
    jdet = jfaces.RetinaFaceDetector(weights_dir=str(tmp_path), score_thresh=0.5)
    frame = face_frame(5, 70, 100)
    got, want = det.detect(frame), jdet.detect(frame)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert max(abs(g.x0 - w.x0), abs(g.y0 - w.y0), abs(g.x1 - w.x1), abs(g.y1 - w.y1)) <= 1
        assert abs(g.confidence - w.confidence) < 5e-3


# -- GFPGAN ----------------------------------------------------------------------------

def test_tiny_gfpgan_equals_jax(tiny_gfpgan):
    """The 64-pixel stand-in against JAX ``gfpgan.apply``: the JAX
    package's bound against its torch reference is 1e-2
    (tests/test_restoration_stack.py); the port is held to 1e-4."""
    cfg = config_from_params(tiny_gfpgan)
    assert cfg == GFPGANConfig(**TINY)
    net = GFPGAN.from_state_dict(cfg, registry.from_jax_params(tiny_gfpgan, torch.float32),
                                 "cpu")
    x = np.random.default_rng(0).random((2, 64, 64, 3), dtype=np.float32) * 2 - 1
    with torch.no_grad():
        got = net.apply(torch.from_numpy(x)).numpy()
    want = np.asarray(jgfpgan.apply(tiny_gfpgan, x, jgfpgan.GFPGANConfig(**TINY)))
    assert np.abs(got - want).max() < 1e-4, np.abs(got - want).max()


def test_published_gfpgan_options_equal_jax():
    """GFPGANv1.4's own options (``channel_multiplier=2``, 8 MLP layers,
    full width) at 128 pixels, so that every channel and key mapping the
    published widths reach below the 512-pixel levels is held to JAX
    ``gfpgan.apply`` (measured max 8.3e-6); within 1e-4."""
    jcfg = jgfpgan.GFPGANConfig(out_size=128)
    params = _np_tree(jgfpgan.init(jax.random.PRNGKey(6), jcfg))
    cfg = config_from_params(params)
    assert cfg == GFPGANConfig(out_size=128)
    assert (cfg.channel_multiplier, cfg.num_mlp, cfg.narrow) == (2, 8, 1.0)
    net = GFPGAN.from_state_dict(cfg, registry.from_jax_params(params, torch.float32), "cpu")
    x = np.random.default_rng(0).random((1, 128, 128, 3), dtype=np.float32) * 2 - 1
    with torch.no_grad():
        got = net.apply(torch.from_numpy(x)).numpy()
    del net
    want = np.asarray(jgfpgan.apply(params, x, jcfg))
    assert np.abs(got - want).max() < 1e-4, np.abs(got - want).max()


def test_published_gfpgan_widths():
    """The published arch: 177.6 M parameters, the JAX tree's names."""
    with torch.device("meta"):
        net = GFPGAN(GFPGANConfig())
    assert sum(p.numel() for p in net.parameters()) == 177_576_252
    assert registry.AUX_SPECS["GFPGANv1.4"].arch_config == GFPGANConfig()


# -- the face restorer ---------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["sr", "gfpgan"])
def test_restore_frame_equals_jax(tmp_path, tiny_gfpgan, backend):
    """``restore_frame`` on a frame with skin regions against JAX's
    ``FaceRestorer`` with the same weights (sr: realesr-general-x4v3 from
    a seeded checkpoint in both weights directories; gfpgan: the JAX
    stand-in, which the port reads as ``GFPGANv1.4.npz``): within 1 LSB
    on <= 0.1% of the values, the same faces restored."""
    wdir = tmp_path / "w"
    if backend == "sr":
        registry.write_npz(registry.init_params(SRVGGConfig(num_conv=32, scale=4), seed=9),
                           wdir / "realesr-general-x4v3.npz")
        jcfg = jfaces.FaceRestoreConfig(backend="sr", weights_dir=str(wdir))
    else:
        export_npz(tiny_gfpgan, wdir / "GFPGANv1.4.npz")
        jcfg = jfaces.FaceRestoreConfig(backend="gfpgan")       # the stand-in
    frame = face_frame(7)
    port = faces.FaceRestorer(faces.FaceRestoreConfig(backend=backend, weights_dir=str(wdir),
                                                      device="cpu"))
    port.setup(*frame.shape[:2])
    jax_r = jfaces.FaceRestorer(jcfg)
    jax_r.setup(*frame.shape[:2])
    assert port.config.crop_size == jax_r.config.crop_size
    got, want = port.restore_frame(frame), jax_r.restore_frame(frame)
    assert port.result.faces_restored == jax_r.result.faces_restored >= 1
    assert not np.array_equal(got, frame)
    _within_one_lsb(got, want)


def test_missing_gfpgan_checkpoint_raises_input_error(tmp_path):
    restorer = faces.FaceRestorer(faces.FaceRestoreConfig(backend="gfpgan",
                                                          weights_dir=str(tmp_path),
                                                          device="cpu"))
    with pytest.raises(InputError, match="GFPGANv1.4"):
        restorer.setup(64, 64)


def test_codeformer_raises_naming_a9b(tmp_path, capsys):
    """A9b is done: ``face_model="codeformer"`` is accepted, and without
    ``CodeFormer.npz`` (or its ``.pth``) in the weights directory the face
    restorer and a restore raise ``InputError`` naming it before any
    compute (the JAX restorer runs a random stand-in;
    tests/test_torch_codeformer.py holds the backend to JAX's)."""
    from test_torch_film import _write, film_clip

    assert Config(face_restore=True, face_model="codeformer").face_model == "codeformer"
    restorer = faces.FaceRestorer(faces.FaceRestoreConfig(backend="codeformer",
                                                          weights_dir=str(tmp_path),
                                                          device="cpu"))
    with pytest.raises(InputError, match="CodeFormer"):
        restorer.setup(64, 64)
    src = _write(tmp_path / "a.y4m", film_clip(4))
    rc = cli.main(["restore", str(src), "--preset", "archive", "--face-model", "codeformer",
                   "--device", "cpu", "--weights-dir", str(tmp_path / "w"),
                   "--project-dir", str(tmp_path / "p")])
    assert rc == 1 and str(tmp_path / "w" / "CodeFormer.npz") in capsys.readouterr().err


class _Captured(Exception):
    pass


def test_weights_dir_reaches_the_face_restorer(tmp_path, monkeypatch):
    """The port's restore builds its face restorer with the config's
    weights directory; the JAX restorer builds ``FaceRestoreConfig``
    without one, so its GFPGAN never reads a user checkpoint (ROADMAP.md,
    "JAX faults")."""
    from framewright_tpu.config import Config as JaxConfig
    from framewright_tpu_torch import restorer as prestorer
    from test_torch_film import _PortSR, _write, film_clip

    seen = {}

    def capture(cfg):
        seen[type(cfg).__module__.split(".")[0]] = cfg
        raise _Captured

    src = _write(tmp_path / "a.y4m", film_clip(4))
    export_npz(_np_tree(jgfpgan.init(jax.random.PRNGKey(6), jgfpgan.GFPGANConfig(**TINY))),
               tmp_path / "GFPGANv1.4.npz")
    monkeypatch.setattr(prestorer, "FaceRestorer", capture)
    with pytest.raises(_Captured):
        VideoRestorer(Config(sr_model="FW_fast6_x2", device_platform="cpu", face_restore=True,
                             weights_dir=tmp_path, project_dir=tmp_path / "p"))\
            .restore_video(src, tmp_path / "o.y4m")
    monkeypatch.setattr(jfaces, "FaceRestorer", capture)
    monkeypatch.setattr(jrestorer, "SuperResolution", _PortSR)
    with pytest.raises(StageError):         # the JAX pipeline wraps the stage's error
        jrestorer.VideoRestorer(JaxConfig(sr_model="FW_fast6_x2", face_restore=True,
                                          project_dir=tmp_path / "j", checkpoint_enabled=False))\
            .restore_video(src, tmp_path / "j.y4m")
    assert seen["framewright_tpu_torch"].weights_dir == str(tmp_path)
    assert seen["framewright_tpu"].weights_dir is None
