"""The REST API on the CPU against the JAX package's: the two servers
answer the same requests with the same statuses and JSON keys (the cases
of tests/test_api_integrations.py:64-207, 370-385), a job's output is the
CLI restore's and within the restore bound of JAX's job, the SSE stream
gives a job's states in order, the port's ``/api/frame?job=``. Servers
bind 127.0.0.1 on port 0 and are stopped in a ``finally``; the tests wait
on events or on the SSE stream, never on a wall-clock poll."""

import contextlib
import dataclasses
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from framewright_tpu.api import APIServer as JaxAPIServer
from framewright_tpu_torch import cli
from framewright_tpu_torch.api import APIServer
from framewright_tpu_torch.config import Config
from framewright_tpu_torch.errors import DeviceError
from framewright_tpu_torch.io.y4m import Y4MReader, Y4MWriter

WAIT = 120.0                    # the cap on a job or an event
RESTORE_MAX, RESTORE_MEAN = 2, 0.2      # tests/test_torch_slice.py


@pytest.fixture(autouse=True)
def _few_threads(tmp_path, monkeypatch):
    monkeypatch.setenv("FRAMEWRIGHT_WEIGHTS_DIR", str(tmp_path / "no_weights"))
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def serving(server, process_jobs=False):
    try:
        server.start(process_jobs=process_jobs)
        yield server
    finally:
        server.stop()


@pytest.fixture
def both(tmp_path):
    """(the port's server on the CPU, JAX's server), not processing jobs."""
    with serving(APIServer(tmp_path / "port.db", port=0, device="cpu")) as p, \
            serving(JaxAPIServer(tmp_path / "jax.db", port=0)) as j:
        yield p, j


def request(srv, method, path, payload=None):
    """-> (status, content type, body bytes)."""
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}", data=data,
                                 method=method, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def clip(path, n=3, h=24, w=32, seed=3):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    with Y4MWriter(path, w, h, fps=12) as wr:
        for t in range(n):
            g = 127 + 100 * np.sin(x / 5 + y / 7 + rng.random() * 6 + t * 0.3)
            wr.write_frame(np.clip(np.stack([g, g * 0.9 + 10, g * 0.8 + 20], -1), 0, 255
                                   ).astype(np.uint8))
    return path


def _shape(v):
    """The JSON's keys, recursively (list items by their first)."""
    if isinstance(v, dict):
        return {k: _shape(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_shape(v[0])] if v else []
    return type(v).__name__ if isinstance(v, bool) else "value"


CASES = [
    ("GET", "/api/health", None),
    ("GET", "/api/presets", None),
    ("GET", "/api/recipes", None),
    ("GET", "/api/hardware", None),
    ("GET", "/api/jobs", None),
    ("GET", "/api/jobs/nope", None),
    ("GET", "/api/jobs/nope/log", None),
    ("GET", "/api/preview/nope", None),
    ("GET", "/api/preview-status", None),
    ("GET", "/api/nothing", None),
    ("POST", "/api/jobs", {}),
    ("POST", "/api/jobs", {"config": {"crf": 20}}),
    ("POST", "/api/jobs", {"source": "x", "config": {"crf": 99}}),
    ("POST", "/api/jobs", {"source": "a.y4m", "config": {"recipe": "no_such_recipe"}}),
    ("POST", "/api/jobs", {"source": "a.y4m", "config": {"preset": "nope"}}),
    ("POST", "/api/preview", {"source": "/no/such.y4m"}),
    ("POST", "/api/analyze", {"source": "/no/such.y4m"}),
    ("POST", "/api/recommend", {"source": "/no/such.y4m"}),
    ("POST", "/api/nothing", {"a": 1}),
    ("DELETE", "/api/jobs/nope", None),
    ("DELETE", "/api/nothing", None),
]


@pytest.mark.parametrize("method,path,payload", CASES)
def test_same_status_and_keys_as_jax(both, method, path, payload):
    port, jax_ = both
    (sp, cp, bp), (sj, cj, bj) = (request(s, method, path, payload) for s in (port, jax_))
    assert (sp, cp) == (sj, cj)
    got, want = json.loads(bp), json.loads(bj)
    if path == "/api/hardware":        # the card's report: a card's memory, not HBM
        assert set(got) == set(want) - {"hbm_gb_per_device"} | {"memory_gb_per_device"}
        assert got["platform"] == "cpu"
        return
    assert _shape(got) == _shape(want)
    if path == "/api/recipes":          # without JAX's TPU rate
        assert got == {k: v.replace("(22 fps/chip; ", "(") for k, v in want.items()}


def test_models_catalog_has_jax_entries_for_the_port_models(both):
    port, jax_ = both
    got = json.loads(request(port, "GET", "/api/models")[2])
    want = json.loads(request(jax_, "GET", "/api/models")[2])
    assert set(got) <= set(want) and "RealESRGAN_x2plus" in got
    for name, entry in got.items():
        assert set(entry) == set(want[name]) and entry["scale"] == want[name]["scale"]


def test_job_lifecycle_as_jax(both):
    """Submit (201), read (pending), list, cancel (200), a config override
    and a recipe job land in the job's config, as in JAX."""
    for srv in both:
        code, _, out = request(srv, "POST", "/api/jobs", {"source": "a.y4m",
                                                          "config": {"crf": 22}})
        jid = json.loads(out)["job_id"]
        assert code == 201
        code, _, job = request(srv, "GET", f"/api/jobs/{jid}")
        job = json.loads(job)
        assert code == 200 and job["state"] == "pending" and job["config"]["crf"] == 22
        code, _, out = request(srv, "POST", "/api/jobs",
                               {"source": "a.y4m", "config": {"recipe": "dvd_upscale"}})
        assert code == 201
        rid = json.loads(out)["job_id"]
        assert json.loads(request(srv, "GET", f"/api/jobs/{rid}")[2])["config"][
            "sr_model"] == "RealESRGAN_x4plus"
        assert len(json.loads(request(srv, "GET", "/api/jobs")[2])) == 2
        code, _, out = request(srv, "DELETE", f"/api/jobs/{jid}")
        assert code == 200 and json.loads(out) == {"job_id": jid, "state": "cancelled"}
    port_job = json.loads(request(both[0], "GET", "/api/jobs")[2])[0]
    assert port_job["config"]["device_platform"] == "cpu"   # the server's device


def test_preset_job_config(both):
    port, _ = both
    code, _, out = request(port, "POST", "/api/jobs", {"source": "a.y4m", "config": {
        "preset": "fast", "crf": 30, "device_platform": "cuda"}})
    job = json.loads(request(port, "GET", f"/api/jobs/{json.loads(out)['job_id']}")[2])
    assert code == 201
    assert (job["config"]["preset"], job["config"]["sr_model"], job["config"]["crf"],
            job["config"]["device_platform"]) == ("fast", "FW_fastvgg_x2", 30, "cuda")


def test_config_schema_covers_every_port_field_in_jax_groups(both):
    port, jax_ = both
    schema = json.loads(request(port, "GET", "/api/config_schema")[2])
    jschema = json.loads(request(jax_, "GET", "/api/config_schema")[2])
    names = [f["name"] for g in schema for f in g["fields"]]
    assert sorted(names) == sorted(f.name for f in dataclasses.fields(Config) if f.init)
    assert len(names) == len(set(names))
    assert [g["group"] for g in schema] == [g["group"] for g in jschema]
    jax_fields = {f["name"]: (g["group"], f) for g in jschema for f in g["fields"]}
    for g in schema:
        for f in g["fields"]:
            if f["name"] in jax_fields:
                jg, jf = jax_fields[f["name"]]
                assert g["group"] == jg, f["name"]
                assert (f["type"], f["default"]) == (jf["type"], jf["default"]), f["name"]
    sr = next(f for g in schema for f in g["fields"] if f["name"] == "sr_model")
    assert "RealESRGAN_x2plus" in sr["choices"] and "none" not in sr["choices"]


@pytest.mark.parametrize("needle", [b"/api/frame", b"gal-", b"/api/config_schema", b"cfgpanel",
                                    b"/api/recommend", b"guided restore", b"loadRecipes",
                                    b"loadHardware", b"analyzeSrc"])
def test_dashboard_is_jax_page_with_the_ports_name(both, needle):
    port, jax_ = both
    code, ctype, body = request(port, "GET", "/")
    _, _, jbody = request(jax_, "GET", "/")
    assert code == 200 and ctype == "text/html" and needle in body
    assert b"<title>framewright-tpu-torch</title>" in body
    assert body.replace(b"framewright-tpu-torch", b"framewright-tpu") == jbody


def test_recommend_and_analyze_equal_jax(both, tmp_path):
    """The guided flow on a noisy clip: the same analysis, preset and
    overrides as JAX's; the recommendation submits as a job."""
    rng = np.random.default_rng(0)
    src = tmp_path / "noisy.y4m"
    base = rng.integers(40, 200, (48, 64, 3)).astype(np.float32)
    with Y4MWriter(src, 64, 48, fps=24) as w:
        for _ in range(10):
            w.write_frame(np.clip(base + rng.normal(0, 15, base.shape), 0, 255).astype(np.uint8))
    port, jax_ = both
    got = json.loads(request(port, "POST", "/api/recommend", {"source": str(src)})[2])
    want = json.loads(request(jax_, "POST", "/api/recommend", {"source": str(src)})[2])
    assert (got["analysis"], got["preset"], got["overrides"]) == (
        want["analysis"], want["preset"], want["overrides"])
    assert got["overrides"].get("denoise") is True
    assert json.loads(request(port, "POST", "/api/analyze", {"source": str(src)})[2]) == \
        got["analysis"]
    code, _, out = request(port, "POST", "/api/jobs", {"source": str(src), "config": {
        **got["overrides"], "preset": got["preset"]}})
    assert code == 201 and json.loads(out)["job_id"]


def test_job_log_and_frame_endpoints_as_jax(both, tmp_path):
    src = clip(tmp_path / "c.y4m", n=4, h=48, w=64)
    for srv in both:
        assert request(srv, "GET", f"/api/frame?source={src}&t=1")[0] == 403
        jid = json.loads(request(srv, "POST", "/api/jobs", {"source": str(src)})[2])["job_id"]
        code, ctype, png = request(srv, "GET", f"/api/frame?source={src}&t=1")
        assert (code, ctype, png[:8]) == (200, "image/png", b"\x89PNG\r\n\x1a\n")
        logger = "framewright_tpu_torch" if srv is both[0] else "framewright_tpu"

        def fake(job, logger=logger):
            import logging

            logging.getLogger(f"{logger}.restorer").info("stage enhance started")

        srv.queue.process_fn = fake
        srv.queue.process_next()
        lines = json.loads(request(srv, "GET", f"/api/jobs/{jid}/log")[2])["lines"]
        assert any("stage enhance started" in ln for ln in lines)
    assert request(both[0], "GET", "/api/frame?source=x&t=zz")[0] == 400


def test_rate_limit_answers_429_as_jax(tmp_path):
    with serving(APIServer(tmp_path / "p.db", port=0, rate_per_s=1.0, device="cpu")) as p, \
            serving(JaxAPIServer(tmp_path / "j.db", port=0, rate_per_s=1.0)) as j:
        for srv in (p, j):
            codes = [request(srv, "GET", "/api/health")[0] for _ in range(4)]
            assert codes[:2] == [200, 200] and codes[-1] == 429
            assert json.loads(request(srv, "GET", "/api/health")[2]) == {"error": "rate limited"}


def test_server_without_a_card_raises_device_error(tmp_path):
    with pytest.raises(DeviceError, match="no CUDA device"):
        APIServer(tmp_path / "x.db", port=0)
    assert not (tmp_path / "x.db").exists()


# -- jobs on the worker thread, the SSE stream -------------------------------------------

def sse_until_done(srv, jid, on_state=None):
    """The job's states from the SSE stream, in order, until it ends."""
    states = []
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/api/events", timeout=WAIT) as r:
        for line in r:
            if not line.startswith(b"data:"):
                continue
            job = next(j for j in json.loads(line[5:]) if j["job_id"] == jid)
            if not states or states[-1] != job["state"]:
                states.append(job["state"])
                if on_state:
                    on_state(job["state"])
            if job["state"] in ("completed", "failed", "cancelled"):
                return states, job


def test_sse_stream_gives_the_jobs_states_in_order(tmp_path):
    """A job held in its process until the stream has shown it running:
    pending (or already running), running, completed, in that order; a
    failing job's stream ends on failed with its error."""
    seen_running = threading.Event()

    def process(job):
        if job.source == "bad.y4m":
            raise RuntimeError("no such clip")
        assert seen_running.wait(WAIT)

    with serving(APIServer(tmp_path / "s.db", port=0, device="cpu"),
                 process_jobs=True) as srv:
        srv.queue.process_fn = process
        jid = json.loads(request(srv, "POST", "/api/jobs", {"source": "a.y4m"})[2])["job_id"]
        states, job = sse_until_done(
            srv, jid, lambda s: seen_running.set() if s == "running" else None)
        assert states in (["pending", "running", "completed"], ["running", "completed"])
        bid = json.loads(request(srv, "POST", "/api/jobs", {"source": "bad.y4m"})[2])["job_id"]
        states, job = sse_until_done(srv, bid)
        assert states[-1] == "failed" and job["error"] == "no such clip"


def test_job_output_is_the_cli_restore_and_within_jax_bound(tmp_path):
    """A job restored by the worker thread: byte-equal to the port's CLI
    restore of the clip with the same config, and within the restore bound
    of JAX's server's job (FW_fastvgg_x2, trained)."""
    src = clip(tmp_path / "c.y4m")
    config = {"sr_model": "FW_fastvgg_x2", "checkpoint_enabled": False}
    outs = {}
    for name, srv in (("port", APIServer(tmp_path / "p.db", port=0, device="cpu")),
                      ("jax", JaxAPIServer(tmp_path / "j.db", port=0))):
        with serving(srv, process_jobs=True):
            out = tmp_path / f"{name}.y4m"
            jid = json.loads(request(srv, "POST", "/api/jobs", {
                "source": str(src), "output": str(out),
                "config": {**config, "project_dir": str(tmp_path / f"p_{name}")}})[2])["job_id"]
            states, job = sse_until_done(srv, jid)
            assert job["state"] == "completed", job
            if name == "port":
                code, ctype, png = request(srv, "GET", f"/api/frame?job={jid}&t=1")
                from PIL import Image

                with Y4MReader(out) as r:
                    want = list(r)[1]
                assert (code, ctype) == (200, "image/png")
                assert np.array_equal(np.asarray(Image.open(io.BytesIO(png)).convert("RGB")),
                                      want)
                assert request(srv, "GET", "/api/frame?job=nope&t=0")[0] == 404
        outs[name] = out
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(["restore", str(src), "-o", str(tmp_path / "cli.y4m"), "--model",
                         "FW_fastvgg_x2", "--device", "cpu", "--no-checkpoint",
                         "--project-dir", str(tmp_path / "p_cli")]) == 0
    assert outs["port"].read_bytes() == (tmp_path / "cli.y4m").read_bytes()
    hp, hj = (p.read_bytes().split(b"\n", 1) for p in (outs["port"], outs["jax"]))
    assert hp[0] == hj[0]
    for a, b in zip(hp[1].split(b"FRAME\n")[1:], hj[1].split(b"FRAME\n")[1:]):
        d = np.abs(np.frombuffer(a, np.uint8).astype(np.int16) - np.frombuffer(b, np.uint8))
        assert d.max() <= RESTORE_MAX and d.mean() <= RESTORE_MEAN, (d.max(), d.mean())
