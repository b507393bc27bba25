"""The port's cloud burst (``framewright_tpu_torch/cloud.py``) against the
JAX package's: every case of ``tests/test_cloud.py`` on the port, each
provider and storage request (method, URL, headers, body bytes, the SigV4
and SharedKey signatures at a fixed date) equal to the JAX class's on the
same inputs and fake replies; the three JAX faults the port does not copy
(workers on the CPU in a stripped environment, a dead fleet that is
silent until the timeout, a provisioning error lost in a timer thread);
a burst of two ``--device cpu`` worker processes through the CLI whose
merge equals the in-process restore byte for byte and JAX's restore
within max 2, mean 0.2 LSB (the bound of ``tests/test_torch_slice.py``);
a worker that finds no card failing its chunk; and the RunPod burst
through the CLI timing out and terminating its pods. No test waits on a
wall clock: processes are joined, and a run's own timeout ends it."""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from framewright_tpu import cloud as jcloud
from framewright_tpu_torch import cli, cloud
from framewright_tpu_torch.config import Config
from framewright_tpu_torch.errors import ConfigError
from framewright_tpu_torch.io.y4m import Y4MReader, Y4MWriter

RESTORE_MAX, RESTORE_MEAN = 2, 0.2


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class FakeTransport:
    def __init__(self, responses):
        self.responses = list(responses)
        self.calls = []

    def __call__(self, method, url, headers, body):
        self.calls.append((method, url, dict(headers), body))
        return self.responses.pop(0)


def twin(scenario, *args):
    """``scenario(mod, *args)`` on JAX's module and on the port's, each with
    its own transport; both results and both transports' calls."""
    return scenario(jcloud, *args), scenario(cloud, *args)


def same_requests(j, p):
    (jres, jtr), (pres, ptr) = j, p
    assert ptr.calls == jtr.calls
    return pres, ptr


# -- providers ---------------------------------------------------------------------------

def _runpod_lifecycle(mod):
    tr = FakeTransport([
        (200, {"data": {"podFindAndDeployOnDemand": {"id": "pod1", "costPerHr": 0.44}}}),
        (200, {"data": {"pod": {"desiredStatus": "RUNNING", "runtime": {"uptimeInSeconds": 5}}}}),
        (200, {"data": {"podTerminate": None}}),
    ])
    p = mod.RunPodProvider(api_key="k", transport=tr)
    inst = p.provision(mod.InstanceSpec(accelerator="NVIDIA RTX 4090", env={"A": 'va"l'}))
    st = p.status(inst)
    p.terminate(inst)
    return (inst.instance_id, inst.usd_per_hour, st, inst.status), tr


def test_runpod_provision_and_lifecycle():
    (jres, _), (res, tr) = j, p = twin(_runpod_lifecycle)
    same_requests(j, p)
    assert res == jres == ("pod1", 0.44, "running", "stopped")
    assert all("api_key" not in c[1] for c in tr.calls)
    assert all(c[2]["Authorization"] == "Bearer k" for c in tr.calls)
    payload = json.loads(tr.calls[0][3])
    assert "podFindAndDeployOnDemand" in payload["query"]
    inp = payload["variables"]["input"]
    assert inp["gpuTypeId"] == "NVIDIA RTX 4090" and inp["env"] == [{"key": "A", "value": 'va"l'}]


def _runpod_bytes(mod):
    tr = FakeTransport([(200, json.dumps({"data": {"podFindAndDeployOnDemand": {
        "id": "p2", "costPerHr": 0.2}}}).encode())])
    return mod.RunPodProvider("k", tr).provision(mod.InstanceSpec()).instance_id, tr


def test_runpod_json_bytes_transport():
    (jres, _), (res, _) = j, p = twin(_runpod_bytes)
    same_requests(j, p)
    assert res == jres == "p2"


@pytest.mark.parametrize("mod", [jcloud, cloud], ids=["jax", "port"])
def test_runpod_api_error_raises(mod):
    tr = FakeTransport([(200, {"errors": [{"message": "nope"}]})])
    with pytest.raises(mod.CloudError, match="runpod API error"):
        mod.RunPodProvider("k", tr).provision(mod.InstanceSpec())


def _vast_cheapest(mod):
    tr = FakeTransport([(200, {"offers": [{"id": 7, "dph_total": 0.19},
                                          {"id": 9, "dph_total": 0.30}]}),
                        (200, {"success": True, "new_contract": 1234})])
    inst = mod.VastAIProvider("k", tr).provision(
        mod.InstanceSpec(accelerator="RTX_4090", max_usd_per_hour=0.5))
    return (inst.instance_id, inst.usd_per_hour), tr


def test_vastai_picks_cheapest_offer():
    (jres, _), (res, tr) = j, p = twin(_vast_cheapest)
    same_requests(j, p)
    assert res == jres == ("1234", 0.19) and "/asks/7/" in tr.calls[1][1]


def test_vastai_no_offers():
    for mod in (jcloud, cloud):
        with pytest.raises(mod.CloudError, match="no vast.ai offers"):
            mod.VastAIProvider("k", FakeTransport([(200, {"offers": []})])).provision(
                mod.InstanceSpec())


def _vast_status(mod):
    tr = FakeTransport([(200, {"instances": {"actual_status": "running"}}),
                        (200, {"instances": {"actual_status": "loading"}}),
                        (200, {"actual_status": "exited"}), (200, {})])
    p = mod.VastAIProvider("k", tr)
    inst = mod.CloudInstance("vastai", "1")
    out = [p.status(inst) for _ in range(3)]
    p.terminate(inst)
    return out, tr


def test_vastai_status_mapping():
    (jres, _), (res, tr) = j, p = twin(_vast_status)
    same_requests(j, p)
    assert res == jres == ["running", "provisioning", "stopped"]
    assert tr.calls[-1][0] == "DELETE"


def test_tpu_pod_provider_is_refused_for_want_of_a_card(tmp_path):
    """JAX's TPUPodProvider rents a TPU VM ('v5litepod-8'); the port's
    workers need a CUDA card, so ``--burst gcp-tpu`` is a ConfigError,
    before any request or file."""
    assert "gcp-tpu" in jcloud.PROVIDERS and "gcp-tpu" not in cloud.PROVIDERS
    assert not hasattr(cloud, "TPUPodProvider")
    with pytest.raises(ConfigError, match="TPU VM"):
        cloud.provider_for("gcp-tpu", tmp_path)
    assert isinstance(cloud.provider_for("runpod", api_key="k"), cloud.RunPodProvider)
    assert cloud.provider_for("local", tmp_path, device="cpu").device == "cpu"


# -- SigV4 and storage -------------------------------------------------------------------

SIGV4_CASES = [
    ("PUT", "https://b.s3.us-east-1.amazonaws.com/k", "us-east-1", "S1", b"data"),
    ("PUT", "https://b.s3.us-east-1.amazonaws.com/k", "us-east-1", "S2", b"data"),
    ("GET", "https://b.s3.r.amazonaws.com/x", "r", "SK", b""),
    ("GET", "https://b.s3.r.amazonaws.com/a%20b/c.y4m?b=2&a=1", "r", "SK", b""),
    ("GET", "https://b.s3.r.amazonaws.com/a%2520b/c.y4m?a=1&b=2", "r", "SK", b""),
    ("HEAD", "https://b.s3.r.amazonaws.com/k?x=&y=a b", "r", "SK", b""),
]


@pytest.mark.parametrize("case", SIGV4_CASES, ids=lambda c: f"{c[0]}-{c[1][-12:]}")
def test_sigv4_equals_jax(case):
    method, url, region, secret, payload = case
    args = (method, url, region, "s3", "AK", secret, payload, "20260816T120000Z")
    assert cloud.sigv4_headers(*args) == jcloud.sigv4_headers(*args)


def test_sigv4_deterministic_key_sensitive_and_hash():
    import hashlib

    args = dict(method="PUT", url="https://b.s3.us-east-1.amazonaws.com/k", region="us-east-1",
                service="s3", access_key="AK", payload=b"data", amz_date="20260816T120000Z")
    h1 = cloud.sigv4_headers(secret_key="S1", **args)
    assert h1 == cloud.sigv4_headers(secret_key="S1", **args)
    assert h1["Authorization"] != cloud.sigv4_headers(secret_key="S2", **args)["Authorization"]
    assert h1["Authorization"].startswith(
        "AWS4-HMAC-SHA256 Credential=AK/20260816/us-east-1/s3/aws4_request")
    assert "SignedHeaders=host;x-amz-content-sha256;x-amz-date" in h1["Authorization"]
    h = cloud.sigv4_headers("GET", "https://b.s3.r.amazonaws.com/x", "r", "s3", "AK", "SK", b"",
                            "20260816T120000Z")
    assert h["x-amz-content-sha256"] == hashlib.sha256(b"").hexdigest()
    # a pre-encoded path signs in its once-encoded form
    a = cloud.sigv4_headers("GET", "https://b.s3.r.amazonaws.com/a%20b/c.y4m?b=2&a=1", "r",
                            "s3", "AK", "SK", b"", "20260816T120000Z")
    b = cloud.sigv4_headers("GET", "https://b.s3.r.amazonaws.com/a%2520b/c.y4m?a=1&b=2", "r",
                            "s3", "AK", "SK", b"", "20260816T120000Z")
    assert a["Authorization"] != b["Authorization"]


def test_local_dir_storage_roundtrip(tmp_path):
    st = cloud.LocalDirStorage(tmp_path / "store")
    src = tmp_path / "a.bin"
    src.write_bytes(b"hello")
    st.upload(src, "jobs/a.bin")
    assert st.exists("jobs/a.bin") and not st.exists("jobs/missing")
    st.download("jobs/a.bin", tmp_path / "b.bin")
    assert (tmp_path / "b.bin").read_bytes() == b"hello"


BLOB = bytes(range(256)) * 4 + b"\xff\xfe\x00Y4M"


def _storage_ops(mod, tmp_path, kind):
    """Upload, download and exists on one storage, its replies scripted."""
    f = tmp_path / "c.y4m"
    f.write_bytes(b"YUV")
    dst = tmp_path / f"{mod.__name__}.{kind}.bin"
    if kind == "s3":
        tr = FakeTransport([(200, {}), (200, BLOB), (404, b"")])
        st = mod.S3Storage("bkt", "eu-west-1", "AK", "SK", transport=tr,
                           now=lambda: "20260816T120000Z")
        keys = ("parts/c d.y4m", "parts/x.y4m", "parts/none")
    elif kind == "gcs":
        tr = FakeTransport([(200, {}), (200, BLOB), (200, {})])
        st = mod.GCSStorage("bkt", token="tok", transport=tr)
        keys = ("a/b.bin", "a/b.bin", "a/c.bin")
    elif kind == "azure":
        tr = FakeTransport([(201, {}), (200, BLOB), (404, b"")])
        st = mod.AzureBlobStorage("acct", "cont", account_key="QUJD", transport=tr,
                                  now=lambda: "Sun, 17 Aug 2026 12:00:00 GMT")
        keys = ("parts/c.y4m", "x y.y4m", "none")
    else:
        tr = FakeTransport([(200, {"files": []}), (200, {"id": "f1"}),
                            (200, {"files": [{"id": "abc123", "name": "jobs/d.bin"}]}),
                            (200, BLOB), (200, {"files": []})])
        st = mod.GoogleDriveStorage(token="tok", folder_id="fold", transport=tr)
        keys = ("jobs/d.bin", "jobs/d.bin", "it's.bin")
    st.upload(f, keys[0])
    st.download(keys[1], dst)
    return (dst.read_bytes(), st.exists(keys[2])), tr


@pytest.mark.parametrize("kind", ["s3", "gcs", "azure", "gdrive"])
def test_storage_requests_equal_jax_and_download_is_binary_exact(tmp_path, kind):
    (jres, _), (res, tr) = j, p = twin(_storage_ops, tmp_path, kind)
    same_requests(j, p)
    assert res == jres and res[0] == BLOB
    assert res[1] is (kind == "gcs")


def test_s3_put_request_shape(tmp_path):
    tr = FakeTransport([(200, {})])
    st = cloud.S3Storage("bkt", "eu-west-1", "AK", "SK", transport=tr,
                         now=lambda: "20260816T120000Z")
    f = tmp_path / "c.y4m"
    f.write_bytes(b"YUV")
    st.upload(f, "parts/c.y4m")
    m, url, headers, body = tr.calls[0]
    assert m == "PUT" and url == "https://bkt.s3.eu-west-1.amazonaws.com/parts/c.y4m"
    assert body == b"YUV" and "Authorization" in headers


def test_gcs_upload_url(tmp_path):
    tr = FakeTransport([(200, {})])
    f = tmp_path / "d.bin"
    f.write_bytes(b"x")
    cloud.GCSStorage("bkt", token="tok", transport=tr).upload(f, "a/b.bin")
    _, url, headers, _ = tr.calls[0]
    assert "uploadType=media&name=a%2Fb.bin" in url and headers["Authorization"] == "Bearer tok"


def test_azure_put_signs_the_content_type_slot(tmp_path):
    import base64
    import hashlib
    import hmac

    tr = FakeTransport([(201, {})])
    st = cloud.AzureBlobStorage("acct", "cont", account_key="QUJD", transport=tr,
                                now=lambda: "Sun, 17 Aug 2026 12:00:00 GMT")
    f = tmp_path / "c.y4m"
    f.write_bytes(b"YUV")
    st.upload(f, "parts/c.y4m")
    m, url, headers, body = tr.calls[0]
    assert m == "PUT" and url == "https://acct.blob.core.windows.net/cont/parts/c.y4m"
    assert headers["x-ms-blob-type"] == "BlockBlob"
    assert headers["Content-Type"] == "application/octet-stream"
    sts = "\n".join(["PUT", "", "", str(len(body)), "", "application/octet-stream",
                     "", "", "", "", "", ""]) + "\n" + (
        "x-ms-blob-type:BlockBlob\nx-ms-date:Sun, 17 Aug 2026 12:00:00 GMT\n"
        f"x-ms-version:{cloud.AzureBlobStorage._VERSION}\n") + "/acct/cont/parts/c.y4m"
    want = base64.b64encode(hmac.new(base64.b64decode("QUJD"), sts.encode(),
                                     hashlib.sha256).digest()).decode()
    assert headers["Authorization"] == f"SharedKey acct:{want}"


def _azure_sigs(mod, tmp_path):
    f = tmp_path / "f.bin"
    f.write_bytes(b"z")
    sigs, tr = [], None
    for key, path in (("QUJD", "a.bin"), ("QUJE", "a.bin"), ("QUJD", "b.bin")):
        tr = FakeTransport([(201, {})])
        mod.AzureBlobStorage("acct", "cont", account_key=key, transport=tr,
                             now=lambda: "Sun, 17 Aug 2026 12:00:00 GMT").upload(f, path)
        sigs.append(tr.calls[0][2]["Authorization"])
    return sigs, FakeTransport([])


def test_azure_signature_depends_on_key_and_path(tmp_path):
    (jsigs, _), (sigs, _) = twin(_azure_sigs, tmp_path)
    assert sigs == jsigs and len(set(sigs)) == 3


def _gdrive_patch(mod, tmp_path):
    tr = FakeTransport([(200, {"files": [{"id": "old1", "name": "jobs/d.bin"}]}),
                        (200, {"id": "old1"})])
    f = tmp_path / "d.bin"
    f.write_bytes(b"NEWBYTES")
    mod.GoogleDriveStorage(token="tok", folder_id="fold", transport=tr).upload(f, "jobs/d.bin")
    return None, tr


def test_gdrive_reupload_patches_existing_file(tmp_path):
    _, (_, tr) = j, p = twin(_gdrive_patch, tmp_path)
    same_requests(j, p)
    m, url, headers, body = tr.calls[1]
    assert m == "PATCH" and "files/old1" in url and "uploadType=media" in url
    assert body == b"NEWBYTES"


def test_gdrive_upload_multipart_and_lookups(tmp_path):
    tr = FakeTransport([(200, {"files": []}), (200, {"id": "f1"})])
    f = tmp_path / "d.bin"
    f.write_bytes(b"PAYLOAD")
    cloud.GoogleDriveStorage(token="tok", folder_id="fold", transport=tr).upload(f, "jobs/d.bin")
    m, url, headers, body = tr.calls[1]
    assert m == "POST" and "uploadType=multipart" in url and b"PAYLOAD" in body
    assert b'"name": "jobs/d.bin"' in body and b'"parents": ["fold"]' in body
    assert headers["Authorization"] == "Bearer tok"
    tr = FakeTransport([(200, {"files": [{"id": "abc123"}]}), (200, b"\x00\xffY4M")])
    cloud.GoogleDriveStorage(token="tok", transport=tr).download("jobs/d.bin", tmp_path / "o")
    assert (tmp_path / "o").read_bytes() == b"\x00\xffY4M"
    assert "files?q=" in tr.calls[0][1] and "/files/abc123?alt=media" in tr.calls[1][1]
    assert not cloud.GoogleDriveStorage(transport=FakeTransport([(200, {"files": []})])).exists(
        "nope.bin")


def test_burst_needs_a_shared_directory(tmp_path):
    mgr = cloud.CloudBurstManager(_StubProvider(), cloud.S3Storage("b"))
    with pytest.raises(cloud.CloudError, match="LocalDirStorage"):
        mgr.run(tmp_path / "a.y4m", tmp_path / "o.y4m", 4)


# -- policy and lifecycle ----------------------------------------------------------------

class _StubProvider(cloud.CloudProvider):
    """Counts provisions without starting anything."""

    name = "stub"

    def __init__(self, fail_at=None, on_provision=None):
        super().__init__("", cloud._refuse_http)
        self.provisioned, self.terminated = [], []
        self.fail_at, self.on_provision = fail_at, on_provision

    def provision(self, spec):
        if self.on_provision is not None:
            self.on_provision()
        if len(self.provisioned) == self.fail_at:
            raise cloud.CloudError(f"no capacity for instance {self.fail_at}")
        inst = cloud.CloudInstance("stub", str(len(self.provisioned)), status="running",
                                   usd_per_hour=0.5, started_at=time.time())
        self.provisioned.append(inst)
        return inst

    def status(self, instance):
        return instance.status

    def terminate(self, instance):
        self.terminated.append(instance.instance_id)
        instance.status = "stopped"


def test_small_jobs_do_not_burst(tmp_path):
    for mod in (jcloud, cloud):
        mgr = mod.CloudBurstManager(_StubProvider(), mod.LocalDirStorage(tmp_path),
                                    mod.BurstPolicy(min_chunks_per_instance=2))
        assert not mgr.should_burst(total_chunks=3) and mgr.should_burst(total_chunks=8)
        assert mgr.should_burst(4, local_fps=0.5) is True
    assert cloud.CloudBurstManager(_StubProvider(), cloud.LocalDirStorage(tmp_path)).instances_for(
        4) == jcloud.CloudBurstManager(None, None).instances_for(4) == 2


def test_fleet_size_and_budget(tmp_path):
    prov = _StubProvider()
    mgr = cloud.CloudBurstManager(prov, cloud.LocalDirStorage(tmp_path),
                                  cloud.BurstPolicy(max_instances=8, budget_usd=1.4,
                                                    min_chunks_per_instance=2))
    assert mgr.instances_for(10) == 5
    mgr.provision_fleet(cloud.InstanceSpec(max_usd_per_hour=0.5), 5)
    assert len(prov.provisioned) == 2          # a third would pass $1.4 an hour
    assert mgr.teardown() >= 0 and mgr.instances == []
    assert all(i.status == "stopped" for i in prov.provisioned)


def _wait_running(mod):
    tr = FakeTransport([
        (200, {"data": {"pod": {"desiredStatus": "RUNNING", "runtime": None}}}),
        (200, {"data": {"pod": {"desiredStatus": "RUNNING", "runtime": {"uptimeInSeconds": 3}}}}),
    ])
    out = mod.RunPodProvider("k", tr).wait_running(mod.CloudInstance("runpod", "p1"),
                                                   timeout=30.0, poll=0.0)
    return (out.status, out.started_at > 0), tr


def test_wait_running_transitions():
    (jres, _), (res, _) = j, p = twin(_wait_running)
    same_requests(j, p)
    assert res == jres == ("running", True)


def test_wait_running_timeout():
    tr = FakeTransport([(200, {"data": {"pod": {"desiredStatus": "RUNNING",
                                                "runtime": None}}})] * 50)
    with pytest.raises(cloud.CloudError, match="timeout"):
        cloud.RunPodProvider("k", tr).wait_running(cloud.CloudInstance("runpod", "p2"),
                                                   timeout=0.0, poll=0.0)


def test_cost_accrues_with_time():
    now = 1_000_000.0
    for mod in (jcloud, cloud):
        inst = mod.CloudInstance("x", "1", usd_per_hour=1.2, started_at=now - 1800)
        assert inst.cost_so_far(now) == 0.6
        assert mod.CloudInstance("x", "2").cost_so_far(now) == 0.0


# -- the three JAX faults ----------------------------------------------------------------

class _Popen:
    """Records a ``Popen`` call; starts nothing."""

    calls = []

    def __init__(self, argv, **kw):
        _Popen.calls.append((argv, kw))
        self.pid = 4242

    def poll(self):
        return 0


def test_local_worker_runs_on_the_card_with_the_caller_s_environment(tmp_path, monkeypatch):
    """JAX starts ``farm work --device cpu`` with only ``spec.env``, PATH and
    PYTHONPATH, its output to /dev/null; the port's worker runs on
    ``cuda`` (``cpu`` on request) with the caller's environment and
    ``spec.env`` over it, stdout and stderr in files of the job."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    monkeypatch.setenv("FRAMEWRIGHT_WEIGHTS_DIR", str(tmp_path / "w"))
    spec_env = {"FW_X": "1", "FRAMEWRIGHT_WEIGHTS_DIR": str(tmp_path / "w2")}
    _Popen.calls = []
    monkeypatch.setattr(jcloud.subprocess, "Popen", _Popen)
    jcloud.LocalSubprocessProvider(tmp_path).provision(jcloud.InstanceSpec(env=spec_env))
    (jargv, jkw), = _Popen.calls
    assert jargv[-2:] == ["--device", "cpu"] and "CUDA_VISIBLE_DEVICES" not in jkw["env"]
    assert jkw["env"]["PATH"] == "/usr/bin:/bin" and jkw["stderr"] == subprocess.DEVNULL
    _Popen.calls = []
    monkeypatch.setattr(cloud.subprocess, "Popen", _Popen)
    for device in ("cuda", "cpu"):
        prov = cloud.LocalSubprocessProvider(tmp_path, device=device) if device == "cpu" \
            else cloud.LocalSubprocessProvider(tmp_path)
        inst = prov.provision(cloud.InstanceSpec(env=spec_env))
        argv, kw = _Popen.calls[-1]
        assert argv[1:] == ["-m", "framewright_tpu_torch.cli", "farm", "work", str(tmp_path),
                            "--device", device]
        env = kw["env"]
        assert env["CUDA_VISIBLE_DEVICES"] == "0" and env["FW_X"] == "1"
        assert env["FRAMEWRIGHT_WEIGHTS_DIR"] == str(tmp_path / "w2")
        assert env["PYTHONPATH"].split(":")[0] == str(cloud._PACKAGE_ROOT)
        assert Path(inst.meta["stderr"]).parent == tmp_path / "workers"
    assert sorted(p.name for p in (tmp_path / "workers").iterdir()) == [
        "worker_0.err", "worker_0.out", "worker_1.err", "worker_1.out"]


class _DeadPopen:
    """A worker process that has written to its stderr and exited 3 (no
    process is started)."""

    pids = iter(range(9001, 9100))

    def __init__(self, argv, stdin=None, stdout=None, stderr=None, env=None):
        stderr.write(b"worker boom: no chunk for me\n")
        self.pid = next(self.pids)
        self.returncode = 3

    def poll(self):
        return self.returncode

    def wait(self, timeout=None):
        return self.returncode


def _clip(path: Path, n: int = 8, h: int = 64, w: int = 96, seed: int = 9) -> np.ndarray:
    """Smooth progressive colour waves (no chunk reads as interlaced)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    frames = []
    for t in range(n):
        ph = rng.random(3) * 6
        g = 127 + 100 * np.sin(x / 5 + y / 7 + ph[0] + t * 0.3)
        frames.append(np.clip(np.stack([g, g * 0.9 + 10, g * 0.8 + 20], -1), 0, 255)
                      .astype(np.uint8))
    with Y4MWriter(path, w, h, fps=24) as wr:
        for f in frames:
            wr.write_frame(f)
    return np.stack(frames)


def test_dead_fleet_raises_naming_each_exit_and_stderr(tmp_path, monkeypatch):
    """Every instance stopped with chunks left (two workers that wrote to
    their stderr files and exited 3): the port's run raises CloudError
    naming each one's exit code and stderr tail, and tears down; JAX's
    coordinator waits for its timeout."""
    src = tmp_path / "clip.y4m"
    _clip(src, n=4, h=8, w=8)
    monkeypatch.setattr(cloud.subprocess, "Popen", _DeadPopen)
    prov = cloud.LocalSubprocessProvider(device="cpu")
    mgr = cloud.CloudBurstManager(prov, cloud.LocalDirStorage(tmp_path / "job"),
                                  cloud.BurstPolicy(max_instances=2, min_chunks_per_instance=1))
    with pytest.raises(cloud.CloudError) as info:
        mgr.run(src, tmp_path / "o.y4m", 4, chunk_frames=2, timeout=120.0, poll_s=0.05)
    msg = str(info.value)
    assert msg.count("exited with 3") == 2 and msg.count("worker boom: no chunk for me") == 2
    assert "({0: 'pending', 1: 'pending'})" in msg
    assert mgr.instances == [] and prov._procs == {} and not (tmp_path / "o.y4m").exists()
    # JAX: the same dead fleet (instances that never run) is noticed only at the timeout
    jmgr = jcloud.CloudBurstManager(_StubProvider(), jcloud.LocalDirStorage(tmp_path / "jjob"),
                                    jcloud.BurstPolicy(max_instances=2, min_chunks_per_instance=1))
    with pytest.raises(jcloud.FramewrightError, match="timed out"):
        jmgr.run(src, tmp_path / "j.y4m", 4, chunk_frames=2, timeout=0.3)


def test_provisioning_error_reaches_the_caller_after_teardown(tmp_path):
    """The job is published before the first provision, the fleet is
    provisioned in the calling thread, and the provider's error reaches the
    caller after the instances it did start are terminated (JAX's timer
    thread loses it and its coordinator times out)."""
    src = tmp_path / "clip.y4m"
    _clip(src, n=4, h=8, w=8)
    published = []
    job = tmp_path / "job"
    prov = _StubProvider(fail_at=1, on_provision=lambda: published.append(
        (job / "job.json").exists()))
    mgr = cloud.CloudBurstManager(prov, cloud.LocalDirStorage(job),
                                  cloud.BurstPolicy(max_instances=2, min_chunks_per_instance=1))
    with pytest.raises(cloud.CloudError, match="no capacity for instance 1"):
        mgr.run(src, tmp_path / "o.y4m", 4, chunk_frames=2, timeout=120.0)
    assert published == [True, True] and prov.terminated == ["0"] and mgr.instances == []
    jprov = _StubProvider(fail_at=1)
    jmgr = jcloud.CloudBurstManager(jprov, jcloud.LocalDirStorage(tmp_path / "jjob"),
                                    jcloud.BurstPolicy(max_instances=2, min_chunks_per_instance=1))
    with pytest.raises(jcloud.FramewrightError) as jinfo:
        jmgr.run(src, tmp_path / "j.y4m", 4, chunk_frames=2, timeout=0.5)
    assert "timed out" in str(jinfo.value) and "no capacity" not in str(jinfo.value)


def test_budget_that_admits_no_instance_raises(tmp_path):
    src = tmp_path / "clip.y4m"
    _clip(src, n=4, h=8, w=8)
    mgr = cloud.CloudBurstManager(_StubProvider(), cloud.LocalDirStorage(tmp_path / "job"),
                                  cloud.BurstPolicy(budget_usd=0.5))
    with pytest.raises(cloud.CloudError, match="admits no instance"):
        mgr.run(src, tmp_path / "o.y4m", 4, chunk_frames=2, timeout=120.0)


# -- bursts through the CLI --------------------------------------------------------------

def _planes(path: Path):
    with Y4MReader(path) as r:
        return [f for f in r]


def test_local_burst_of_cpu_workers_equals_the_in_process_and_jax_restores(
        tmp_path, monkeypatch, capsys):
    """``farm run --burst local --workers 2 --device cpu`` on 8 frames of
    64x96 in chunks of 2: 4 chunks, 2 provisioned worker processes, each
    chunk ok on the CPU with errors 0; the merge byte-equal to the
    in-process restore and within max 2, mean 0.2 LSB of JAX's restore of
    the clip; no worker left. FW_fastvgg_x2 in float32: in bf16 JAX's XLA
    chain and the port's plain chain round apart by up to 3 LSB on a few
    values of this clip (mean 0.13), a difference of the SRVGG bf16 path,
    not of the burst, which this test holds."""
    from framewright_tpu.config import Config as JConfig
    from framewright_tpu.restorer import VideoRestorer as JRestorer
    from framewright_tpu_torch.restorer import VideoRestorer

    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    src = tmp_path / "clip.y4m"
    _clip(src)
    job, out = tmp_path / "job", tmp_path / "out.y4m"
    started = []
    real = cloud.LocalSubprocessProvider.provision

    def provision(self, spec):
        inst = real(self, spec)
        started.append((inst, self._procs[inst.instance_id]))
        return inst

    monkeypatch.setattr(cloud.LocalSubprocessProvider, "provision", provision)
    rc = cli.main(["farm", "run", str(src), str(job), "-o", str(out), "--burst", "local",
                   "--workers", "2", "--chunk-frames", "2", "--model", "FW_fastvgg_x2",
                   "--scale", "2", "--dtype", "float32", "--device", "cpu", "--timeout", "240"])
    captured = capsys.readouterr()
    assert rc == 0, captured.err
    assert json.loads(captured.out) == {"output": str(out)}
    assert len(started) == 2 and [p.poll() for _, p in started] == [0, 0]
    res = [json.loads((job / "results" / f"chunk_{i}.json").read_text()) for i in range(4)]
    assert all(r["ok"] and r["errors"] == 0 and r["device"] == "cpu" for r in res)
    assert {r["worker"] for r in res} <= {f"{__import__('socket').gethostname()}-{i.instance_id}"
                                          for i, _ in started}
    straight = tmp_path / "straight.y4m"
    VideoRestorer(Config(sr_model="FW_fastvgg_x2", compute_dtype="float32",
                         device_platform="cpu", batch_size=2, checkpoint_enabled=False,
                         validate_output=False, project_dir=tmp_path / "p")).restore_video(
        src, output=straight)
    assert out.read_bytes() == straight.read_bytes()
    jout = tmp_path / "jax.y4m"
    JRestorer(JConfig(sr_model="FW_fastvgg_x2", compute_dtype="float32", scale_factor=2,
                      batch_size=2,
                      checkpoint_enabled=False, validate_output=False,
                      project_dir=str(tmp_path / "pj"))).restore_video(src, output=jout)
    fa, fj = _planes(out), _planes(jout)
    assert len(fa) == len(fj) == 8
    for a, b in zip(fa, fj):
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert d.max() <= RESTORE_MAX and d.mean() <= RESTORE_MEAN, (d.max(), d.mean())


def test_worker_without_a_card_fails_its_chunk_and_the_burst_names_it(tmp_path, capsys):
    """``--burst local`` asks for the card by default; on a host without one
    the worker fails its chunk (it never restores on the CPU) and the run
    fails naming the chunk, the worker and the device error."""
    src = tmp_path / "clip.y4m"
    _clip(src, n=2, h=16, w=16)
    rc = cli.main(["farm", "run", str(src), str(tmp_path / "job"), "-o",
                   str(tmp_path / "o.y4m"), "--burst", "local", "--workers", "1",
                   "--chunk-frames", "2", "--model", "FW_fastvgg_x2", "--scale", "2",
                   "--timeout", "240"])
    err = capsys.readouterr().err
    assert rc == 1 and "farm chunk 0 failed on worker" in err and "CUDA" in err, err
    res = json.loads((tmp_path / "job" / "results" / "chunk_0.json").read_text())
    assert res["ok"] is False and not (tmp_path / "o.y4m").exists()


def test_runpod_burst_times_out_and_terminates_its_pods(tmp_path, monkeypatch, capsys):
    """The RunPod burst through the CLI on a fake transport: two pods for 4
    chunks, no worker ever reports, the run times out and both pods are
    terminated."""
    src = tmp_path / "clip.y4m"
    _clip(src, n=8, h=8, w=8)
    calls = []

    def fake(method, url, headers, body):
        calls.append((method, url, headers, json.loads(body)))
        q = calls[-1][3]["query"]
        if "podFindAndDeployOnDemand" in q:
            n = sum("podFindAndDeployOnDemand" in c[3]["query"] for c in calls)
            return 200, {"data": {"podFindAndDeployOnDemand": {"id": f"pod{n}",
                                                               "costPerHr": 0.4}}}
        if "podTerminate" in q:
            return 200, {"data": {"podTerminate": None}}
        return 200, {"data": {"pod": {"desiredStatus": "RUNNING",
                                      "runtime": {"uptimeInSeconds": 9}}}}

    monkeypatch.setattr(cloud, "_urllib_transport", fake)
    rc = cli.main(["farm", "run", str(src), str(tmp_path / "job"), "-o",
                   str(tmp_path / "o.y4m"), "--burst", "runpod", "--api-key", "KEY",
                   "--workers", "2", "--chunk-frames", "2", "--timeout", "0.2"])
    err = capsys.readouterr().err
    assert rc == 1 and "timed out" in err
    terminated = [c[3]["variables"]["input"]["podId"] for c in calls
                  if "podTerminate" in c[3]["query"]]
    assert terminated == ["pod1", "pod2"]
    assert all(c[2]["Authorization"] == "Bearer KEY" for c in calls)
    assert (tmp_path / "job" / "job.json").exists() and not (tmp_path / "o.y4m").exists()
