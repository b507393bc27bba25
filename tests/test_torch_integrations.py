"""Integrations, export, caches, logging, plugins, quality trends and the
config schema on the CPU against the JAX package: webhooks delivered to a
local server with JAX's payloads, media-server URLs and EDL text equal,
``.cube`` LUTs parsed equal and applied within 1 LSB, the comparison grid
within 1 LSB, the sidecar's keys, the caches (frame keys equal JAX's),
JSON log lines, a plugin loaded by both managers, a trends database
written by one package and read by the other, email to a local SMTP
socket server. Servers bind 127.0.0.1 on port 0 and are shut down in a
``finally``."""

import dataclasses
import json
import logging
import socketserver
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer
from types import SimpleNamespace

import numpy as np
import pytest

from framewright_tpu import cache as jcache
from framewright_tpu import events as jevents
from framewright_tpu import export as jexport
from framewright_tpu import integrations as jintegrations
from framewright_tpu import logging_utils as jlogging
from framewright_tpu import plugins as jplugins
from framewright_tpu import reports as jreports
from framewright_tpu import uploads as juploads
from framewright_tpu.config import Config as JaxConfig
from framewright_tpu_torch import cache, events, export, integrations, logging_utils, plugins
from framewright_tpu_torch import reports, uploads
from framewright_tpu_torch.config import Config, config_schema
from framewright_tpu_torch.errors import ConfigError, DeviceError, InputError


@pytest.fixture
def rng():
    return np.random.default_rng(11)


# -- webhooks and media servers ---------------------------------------------------------

class _Sink(BaseHTTPRequestHandler):
    received: list = []

    def do_POST(self):
        n = int(self.headers.get("Content-Length") or 0)
        self.received.append((self.path, json.loads(self.rfile.read(n)) if n else None))
        self.send_response(200)
        self.end_headers()

    def log_message(self, *a):
        pass


@pytest.fixture
def sink():
    _Sink.received = []
    httpd = HTTPServer(("127.0.0.1", 0), _Sink)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_port}", _Sink.received
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join()


@pytest.mark.parametrize("kind", ["generic", "slack", "discord"])
def test_webhook_payload_equals_jax(kind):
    data = {"frames": 5, "output": "o.y4m"}
    ev = events.Event(type=events.EventType.JOB_COMPLETED, data=data, timestamp=12.5)
    jev = jevents.Event(type=jevents.EventType.JOB_COMPLETED, data=data, timestamp=12.5)
    got = integrations.WebhookNotifier(integrations.WebhookConfig(
        url="https://example.com/h", kind=kind)).payload_for(ev)
    want = jintegrations.WebhookNotifier(jintegrations.WebhookConfig(
        url="https://example.com/h", kind=kind)).payload_for(jev)
    assert got == want


def test_webhook_delivery_on_the_bus_as_jax(sink):
    """Attached to each package's bus: a completed job's payload reaches
    the local server once (the bus calls subscribers in the emitting
    thread), the same as JAX's; an event not subscribed is not sent."""
    url, received = sink
    for mod, emod in ((integrations, events), (jintegrations, jevents)):
        bus = emod.EventBus()
        wh = mod.WebhookNotifier(mod.WebhookConfig(url=url + "/hook"))
        wh.attach(bus)
        bus.emit(emod.EventType.JOB_COMPLETED, frames=7)
        bus.emit(emod.EventType.PROGRESS, frames=1)
        assert len(wh.sent) == 1
    (p1, a), (p2, b) = received
    assert p1 == p2 == "/hook" and len(received) == 2
    assert a.pop("timestamp") > 0 and b.pop("timestamp") > 0
    assert a == b == {"event": "job_completed", "frames": 7}


def test_webhook_refuses_bad_urls_and_reports_failed_sends(monkeypatch):
    with pytest.raises(InputError):
        integrations.WebhookNotifier(integrations.WebhookConfig(url="file:///etc/passwd"))
    monkeypatch.setattr(integrations.time, "sleep", lambda s: None)
    wh = integrations.WebhookNotifier(integrations.WebhookConfig(
        url="http://127.0.0.1:9/none", retries=1, timeout_s=1.0))
    assert wh.send(events.Event(type=events.EventType.JOB_FAILED)) is False and wh.sent == []


@pytest.mark.parametrize("kind", ["plex", "jellyfin", "emby"])
def test_media_server_urls_and_refresh_as_jax(sink, kind):
    url, received = sink
    cfg = dict(kind=kind, base_url=url, token="tok")
    port = integrations.MediaServerNotifier(integrations.MediaServerConfig(**cfg))
    jax_ = jintegrations.MediaServerNotifier(jintegrations.MediaServerConfig(**cfg))
    assert port.refresh_url() == jax_.refresh_url()
    assert port.refresh() is jax_.refresh() is True
    assert received[0] == received[1] and received[0][0].endswith("tok")
    bad = integrations.MediaServerNotifier(integrations.MediaServerConfig("kodi", url))
    with pytest.raises(ValueError, match="kodi"):
        bad.refresh_url()
    assert bad.refresh() is False


@pytest.mark.parametrize("bounds,total,fps", [([24, 72], 120, 24.0), ([], 50, 25.0),
                                              ([10, 10, 33], 90, 29.97)])
def test_edl_text_equals_jax(bounds, total, fps):
    assert integrations.export_edl(bounds, total, fps, title="t") == \
        jintegrations.export_edl(bounds, total, fps, title="t")


# -- LUTs ----------------------------------------------------------------------------------

def _cube(n, fn, header="") -> str:
    rows = [" ".join(f"{v:.6f}" for v in fn(r / (n - 1), g / (n - 1), b / (n - 1)))
            for b in range(n) for g in range(n) for r in range(n)]
    return header + f"TITLE \"t\"\n# a comment\nLUT_3D_SIZE {n}\nDOMAIN_MIN 0 0 0\n" + \
        "\n".join(rows)


LUTS = {
    "identity": lambda r, g, b: (r, g, b),
    "invert": lambda r, g, b: (1 - r, 1 - g, 1 - b),
    "warm": lambda r, g, b: (min(1.0, r * 1.1 + 0.02), g ** 0.9, b * 0.85),
}


@pytest.mark.parametrize("name", sorted(LUTS))
@pytest.mark.parametrize("n", [4, 9])
def test_lut_parse_equal_and_apply_within_one_lsb(rng, name, n):
    text = _cube(n, LUTS[name])
    lut, jlut = integrations.parse_cube_lut(text), jintegrations.parse_cube_lut(text)
    np.testing.assert_array_equal(lut, jlut)
    frame = rng.integers(0, 256, (16, 24, 3), np.uint8)
    d = np.abs(integrations.apply_lut(frame, lut).astype(np.int16)
               - jintegrations.apply_lut(frame, jlut))
    assert d.max() <= 1


def test_bad_lut_raises_as_jax():
    for mod in (integrations, jintegrations):
        with pytest.raises(ValueError, match="bad .cube LUT"):
            mod.parse_cube_lut("LUT_3D_SIZE 2\n0 0 0\n")


# -- export -------------------------------------------------------------------------------

def test_export_presets_equal_jax():
    assert {k: dataclasses.asdict(v) for k, v in export.EXPORT_PRESETS.items()} == \
        {k: dataclasses.asdict(v) for k, v in jexport.EXPORT_PRESETS.items()}
    cfg = export.apply_export_preset(Config(), "youtube_hdr")
    jcfg = jexport.apply_export_preset(JaxConfig(), "youtube_hdr")
    assert (cfg.codec, cfg.crf, cfg.encode_preset, cfg.pixel_format) == (
        jcfg.codec, jcfg.crf, jcfg.encode_preset, jcfg.pixel_format)
    with pytest.raises(ConfigError, match="Unknown export preset"):
        export.get_export_preset("dvd")
    assert export.comparison_html("a.png", "b.png", "T") == \
        jexport.comparison_html("a.png", "b.png", "T")


@pytest.mark.parametrize("sizes", [[(48, 64)], [(48, 64), (30, 40), (27, 50)],
                                   [(100, 60)] * 5])
def test_comparison_grid_within_one_lsb_of_jax(rng, sizes):
    before = [rng.integers(0, 256, (h, w, 3), np.uint8) for h, w in sizes]
    after = [rng.integers(0, 256, (2 * h, 2 * w, 3), np.uint8) for h, w in sizes]
    got = export.comparison_grid(before, after, device="cpu")
    want = jexport.comparison_grid(before, after)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(np.int16) - want).max() <= 1


def test_comparison_grid_needs_a_card_unless_asked_for_the_cpu(rng):
    f = [rng.integers(0, 256, (8, 8, 3), np.uint8)]
    with pytest.raises(DeviceError, match="no CUDA device"):
        export.comparison_grid(f, f)
    with pytest.raises(ValueError):
        export.comparison_grid(f, [], device="cpu")


def test_sidecar_has_jax_keys_with_the_ports_version(tmp_path):
    from framewright_tpu_torch import __version__

    quality = SimpleNamespace(to_dict=lambda: {"psnr": 30.0})
    result = SimpleNamespace(frames_out=4, duration_s=1.234, quality=quality)
    path = export.write_sidecar(tmp_path / "o.y4m", Config(), result, "in.y4m")
    jpath = jexport.write_sidecar(tmp_path / "j.y4m", JaxConfig(), result, "in.y4m")
    got, want = json.loads(path.read_text()), json.loads(jpath.read_text())
    assert path == tmp_path / "o.y4m.json"
    assert set(got) == set(want) - {"framewright_tpu_version"} | {
        "framewright_tpu_torch_version"}
    assert got["framewright_tpu_torch_version"] == __version__
    assert (got["frames_out"], got["duration_s"], got["quality"]) == (
        want["frames_out"], want["duration_s"], want["quality"])
    assert got["config_hash"] == Config().get_hash()


# -- caches --------------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["lru", "lfu", "fifo"])
def test_lru_cache_policies_evict_as_jax(policy):
    """The same puts and gets in both: the same survivors, hits and misses."""
    item = np.zeros(100, np.uint8)
    out = []
    for mod in (cache, jcache):
        c = mod.LRUCache(max_bytes=300, policy=policy)
        for k in "abc":
            c.put(k, item)
        c.get("a")
        c.get("a")
        c.get("b")
        c.put("d", item)
        c.put("e", np.zeros(1000, np.uint8))        # larger than the budget: not kept
        out.append(([k for k in "abcde" if k in c._data], c.hits, c.misses, len(c),
                    c.hit_rate))
    assert out[0] == out[1]


def test_lru_cache_ttl_with_an_injected_clock(monkeypatch):
    now = {"t": 1000.0}
    for mod in (cache, jcache):
        monkeypatch.setattr(mod.time, "time", lambda: now["t"])
    got = []
    for mod in (cache, jcache):
        now["t"] = 1000.0
        c = mod.LRUCache(max_bytes=10_000, ttl_s=5.0)
        c.put("k", "v")
        now["t"] = 1004.0
        first = c.get("k")
        now["t"] = 1006.0
        got.append((first, c.get("k"), len(c)))
    assert got[0] == got[1] == ("v", None, 0)


def test_frame_cache_keys_equal_jax(rng):
    frames = [rng.integers(0, 256, (32, 48, 3), np.uint8) for _ in range(3)]
    for f in frames:
        assert cache.FrameCache.frame_key("sr", f) == jcache.FrameCache.frame_key("sr", f)
    fc, calls = cache.FrameCache(max_bytes=1 << 20), []

    def fn(f):
        calls.append(1)
        return f[::2, ::2].copy()

    a = fc.get_or_compute("sr", frames[0], fn)
    b = fc.get_or_compute("sr", frames[0].copy(), fn)
    assert len(calls) == 1 and b is a and fc.hit_rate == 0.5


def test_model_cache_pins_as_jax():
    got = []
    for mod in (cache, jcache):
        mc = mod.ModelCache(max_models=2)
        mc.get("a", lambda: 1)
        mc.pin("a")
        mc.get("b", lambda: 2)
        mc.get("c", lambda: 3)          # evicts b, not the pinned a
        mc.get("a")
        mc.unpin("a")
        mc.get("d", lambda: 4)          # c, now the least recent, goes
        mc.evict("zz")
        got.append((sorted(mc._models), mc.get("nope"), len(mc), "c" in mc))
    assert got[0] == got[1] == (["a", "d"], None, 2, False)


# -- logging --------------------------------------------------------------------------------

def test_json_formatter_lines_equal_jax():
    rec = logging.LogRecord("framewright_tpu_torch.x", logging.WARNING, __file__, 1,
                            "hello %s", ("world",), None)
    rec.extra_fields = {"frames": 3}
    try:
        raise RuntimeError("boom")
    except RuntimeError:
        import sys

        err = logging.LogRecord("n", logging.ERROR, __file__, 2, "bad", (), sys.exc_info())
    for r in (rec, err):
        assert logging_utils.JsonFormatter().format(r) == jlogging.JsonFormatter().format(r)
    assert json.loads(logging_utils.JsonFormatter().format(rec)) == {
        "ts": round(rec.created, 3), "level": "WARNING", "logger": "framewright_tpu_torch.x",
        "msg": "hello world", "frames": 3}


def test_setup_logging_on_the_ports_root_logger(tmp_path, capsys):
    root = logging_utils.setup_logging(logging.DEBUG, json_format=True,
                                       log_file=tmp_path / "logs" / "fw.log",
                                       module_levels={"framewright_tpu_torch.noisy": 40})
    try:
        assert root.name == "framewright_tpu_torch" and len(root.handlers) == 2
        logging.getLogger("framewright_tpu_torch.restorer").debug("stage %d", 4)
        logging.getLogger("framewright_tpu_torch.noisy").info("dropped")
        for h in root.handlers:
            h.flush()
        lines = (tmp_path / "logs" / "fw.log").read_text().splitlines()
        assert [json.loads(ln)["msg"] for ln in lines] == ["stage 4"]
        assert json.loads(capsys.readouterr().err.splitlines()[-1])["msg"] == "stage 4"
    finally:
        for h in root.handlers:
            h.close()
        logging_utils.setup_logging(logging.INFO)
        logging.getLogger("framewright_tpu_torch.noisy").setLevel(logging.NOTSET)


def test_metrics_log_summary_equals_jax(tmp_path):
    out = []
    for mod, name in ((logging_utils, "p"), (jlogging, "j")):
        m = mod.MetricsLog(tmp_path / f"{name}.jsonl")
        for v in (3.0, 1.0, 2.0):
            m.log("fps", v, stage="enhance")
        m.log("hbm", 7)
        out.append(m.summary())
        lines = (tmp_path / f"{name}.jsonl").read_text().splitlines()
        assert [json.loads(ln)["value"] for ln in lines] == [3.0, 1.0, 2.0, 7]
    assert out[0] == out[1]
    assert out[0]["fps"] == {"count": 3, "sum": 6.0, "min": 1.0, "max": 3.0, "mean": 2.0}


# -- plugins ---------------------------------------------------------------------------------

PLUGIN = '''
import importlib


def register(hooks):
    # the hook points of the package whose manager loads this plugin
    HookPoint = importlib.import_module(type(hooks).__module__).HookPoint
    hooks.register(HookPoint.PRE_STAGE, lambda ctx: ctx.setdefault("seen", []).append("p"),
                   priority=10)
'''


def test_plugin_file_loads_in_both_managers(tmp_path, monkeypatch):
    (tmp_path / "good.py").write_text(PLUGIN)
    (tmp_path / "broken.py").write_text("def nothing():\n    pass\n")
    (tmp_path / "_private.py").write_text("raise SystemExit\n")
    monkeypatch.setenv("FRAMEWRIGHT_PLUGINS_DIR", str(tmp_path))
    assert plugins.default_plugins_dir() == jplugins.default_plugins_dir() == tmp_path
    got = []
    for mod, emod in ((plugins, events), (jplugins, jevents)):
        pm = mod.PluginManager()
        assert pm.load_all() == 1 and pm.load_all() == 0
        ctx = pm.hooks.fire(emod.HookPoint.PRE_STAGE, {})
        got.append((pm.status(), ctx, [p.name for p in pm.discover()]))
    assert got[0] == got[1]
    status, ctx, names = got[0]
    assert names == ["broken", "good"] and ctx == {"seen": ["p"]}
    assert status[0]["name"] == "broken" and "register" in status[0]["error"]
    monkeypatch.delenv("FRAMEWRIGHT_PLUGINS_DIR")
    assert plugins.default_plugins_dir() == jplugins.default_plugins_dir()
    assert plugins.PluginManager(tmp_path / "none").load_all() == 0


# -- quality trends, the config schema --------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "jax"])
def test_trends_database_reads_in_the_other_package(tmp_path, writer):
    db = tmp_path / "t.db"
    first, second = (reports, jreports) if writer == "port" else (jreports, reports)
    w = first.QualityTrends(db)
    for i, passed in enumerate((True, False, True)):
        w.record(f"c{i}.y4m", 30.0 + i, 0.9, 10.0 + i, 4, passed)
    w.close()
    r, again = second.QualityTrends(db), first.QualityTrends(db)
    try:
        assert r.summary() == again.summary() == {"runs": 3, "avg_psnr": 31.0,
                                                  "avg_ssim": 0.9, "avg_fps": 11.0,
                                                  "pass_rate": 0.667}
        assert r.history(limit=2) == again.history(limit=2)
        assert [h["source"] for h in r.history()] == ["c2.y4m", "c1.y4m", "c0.y4m"]
    finally:
        r.close()
        again.close()
    empty = reports.QualityTrends(tmp_path / "e.db")
    assert empty.summary() == jreports.QualityTrends(tmp_path / "e2.db").summary()
    empty.close()


def test_estimate_holds_only_card_figures():
    assert set(reports._FAMILY_FPS_1080P) == {"rrdb", "srvgg", "hat", "basicvsr", "tvsr",
                                              "diffusion"}
    with pytest.raises(ConfigError, match="no card figure"):
        reports.estimate_cost(10, 64, 48, "face")
    e = reports.estimate_cost(10, 64, 48).to_dict()
    assert list(e["est_cost_usd"]) == ["reference_gpu"]


def test_config_schema_covers_every_field_in_jax_groups():
    from framewright_tpu.config import config_schema as jax_schema

    schema = config_schema()
    names = [f["name"] for g in schema for f in g["fields"]]
    assert sorted(names) == sorted(f.name for f in dataclasses.fields(Config) if f.init)
    jgroups = {f["name"]: g["group"] for g in jax_schema() for f in g["fields"]}
    for g in schema:
        order = [f["name"] for f in g["fields"] if f["name"] in jgroups]
        assert all(jgroups[n] == g["group"] for n in order)
        jorder = [f["name"] for jg in jax_schema() if jg["group"] == g["group"]
                  for f in jg["fields"] if f["name"] in order]
        assert order == jorder
    dev = next(f for g in schema for f in g["fields"] if f["name"] == "device_platform")
    assert dev["choices"] == ["auto", "cuda", "cpu"] and dev["default"] == "auto"


# -- email to a local SMTP server ----------------------------------------------------------

class _SMTPHandler(socketserver.StreamRequestHandler):
    """A minimal SMTP server: EHLO, MAIL, RCPT, DATA, QUIT."""

    messages: list = []

    def handle(self):
        def say(line):
            self.wfile.write(line.encode() + b"\r\n")

        say("220 local")
        mail = {"rcpt": []}
        while True:
            line = self.rfile.readline().decode().rstrip("\r\n")
            cmd = line[:4].upper()
            if cmd in ("EHLO", "HELO"):
                say("250 local")
            elif cmd == "MAIL":
                mail["from"] = line.split(":", 1)[1].strip()
                say("250 ok")
            elif cmd == "RCPT":
                mail["rcpt"].append(line.split(":", 1)[1].strip())
                say("250 ok")
            elif cmd == "DATA":
                say("354 go on")
                body = []
                while True:
                    ln = self.rfile.readline().decode()
                    if ln.rstrip("\r\n") == ".":
                        break
                    body.append(ln)
                mail["data"] = "".join(body)
                self.messages.append(mail)
                mail = {"rcpt": []}
                say("250 queued")
            elif cmd == "QUIT":
                say("221 bye")
                return
            else:
                say("502 no")


@pytest.fixture
def smtp_server():
    _SMTPHandler.messages = []
    srv = socketserver.ThreadingTCPServer(("127.0.0.1", 0), _SMTPHandler)
    srv.daemon_threads = True
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield srv.server_address[1], _SMTPHandler.messages
    finally:
        srv.shutdown()
        srv.server_close()
        t.join()


def test_email_to_a_local_smtp_server_as_jax(smtp_server):
    port, messages = smtp_server
    kw = dict(smtp_host="127.0.0.1", smtp_port=port, sender="fw@local",
              recipients=["a@b.c", "d@e.f"], use_tls=False)
    assert uploads.EmailSender(uploads.EmailConfig(**kw)).send("done", "job ok")
    assert juploads.EmailSender(juploads.EmailConfig(**kw)).send("done", "job ok")
    a, b = messages
    assert a == b and a["from"] == "<fw@local>" and a["rcpt"] == ["<a@b.c>", "<d@e.f>"]
    assert "Subject: done" in a["data"] and "job ok" in a["data"]
    # STARTTLS asked of a server without it: reported, not raised (JAX's too)
    tls = dict(kw, use_tls=True)
    assert uploads.EmailSender(uploads.EmailConfig(**tls)).send("x", "y") is False
    assert juploads.EmailSender(juploads.EmailConfig(**tls)).send("x", "y") is False
    assert uploads.EmailSender(uploads.EmailConfig("127.0.0.1")).send("x", "y") is False


def test_sms_through_an_injected_transport_as_jax():
    calls = []

    def transport(method, url, headers, body):
        calls.append((method, url, headers, json.loads(body)))
        return 202, b""

    for mod in (uploads, juploads):
        assert mod.SMSSender("https://gw/sms", api_key="k", transport=transport).send(
            "+1", "b" * 170)
    assert calls[0] == calls[1] and calls[0][3] == {"to": "+1", "body": "b" * 160}

    def down(*a):
        raise OSError("down")

    assert uploads.SMSSender("https://gw", transport=down).send("+1", "x") is False


def test_port_modules_hold_no_tpu_figures():
    """The estimate, the dashboard, the sidecar and the recipes state no
    TPU rate, price or memory size."""
    from framewright_tpu_torch import api, recipes

    for text in (api._DASHBOARD_HTML, json.dumps({k: r.description for k, r in
                                                  recipes.RECIPES.items()}),
                 json.dumps(reports._FAMILY_FPS_1080P)):
        for word in ("TPU", "v5e", "HBM", "fps/chip"):
            assert word not in text
