"""The cloud burst: rent workers when local capacity runs out (the port of
``framewright_tpu/cloud.py``).

Every provider and storage takes an injectable ``transport(method, url,
headers, body) -> (status, body)``; the default uses urllib. For the same
inputs and replies each request (method, URL, headers and body bytes,
the SigV4 and SharedKey signatures included) is the JAX class's. A burst
publishes the job in a shared directory (``LocalDirStorage``), rents
instances that run farm workers (``parallel/multihost``), waits for the
parts, merges them and always terminates the instances.

``LocalSubprocessProvider`` starts the workers as processes on this host
(``python -m framewright_tpu_torch.cli farm work JOB_DIR --device cuda``):
they restore on the card. JAX's ``TPUPodProvider`` rents a TPU VM, which
has no CUDA card for the port's workers; it is not ported. Three JAX
faults are not copied:

- JAX starts each local worker on the CPU (``--device cpu``) with an
  environment of only ``spec.env``, ``PATH`` and ``PYTHONPATH``; here a
  worker runs on ``device`` (the card by default) with the caller's
  environment and ``spec.env`` over it.
- JAX sends a worker's output to ``/dev/null`` and waits for the
  coordinator's timeout when every worker has died; here each worker's
  stdout and stderr go to files under ``JOB_DIR/workers``, and
  ``CloudBurstManager.run`` raises ``CloudError`` naming each instance's
  exit code and the tail of its stderr once every instance has stopped
  while chunks remain.
- JAX provisions from a timer thread, where a provider's error is lost
  while the coordinator waits; here the job is published first, then the
  fleet is provisioned in the calling thread, and its error reaches the
  caller after the teardown.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import logging
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.parse
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

from framewright_tpu_torch.errors import FramewrightError

logger = logging.getLogger(__name__)

# (method, url, headers, body) -> (status, raw response body); the body is
# bytes, None or an open binary file (sent from the file); fakes may return
# dicts or text, which _as_json and _as_bytes accept
Transport = Callable[[str, str, Dict[str, str], Optional[bytes]], Tuple[int, object]]

# the package's parent directory: on a local worker's PYTHONPATH
_PACKAGE_ROOT = Path(__file__).resolve().parents[1]


class CloudError(FramewrightError):
    pass


def urllib_request(method: str, url: str, headers: Dict[str, str], body):
    """A ``urllib`` request; a body that is an open binary file is sent
    from the file in blocks, with its remaining length as Content-Length
    (``urllib`` would send it chunked)."""
    import urllib.request

    if hasattr(body, "read") and not any(k.lower() == "content-length" for k in headers):
        headers = {**headers, "Content-Length": str(os.fstat(body.fileno()).st_size
                                                    - body.tell())}
    return urllib.request.Request(url, data=body, headers=headers, method=method)


def _urllib_transport(method: str, url: str, headers: Dict[str, str],
                      body: Optional[bytes]) -> Tuple[int, bytes]:
    import urllib.request

    req = urllib_request(method, url, headers, body)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.read()
    except Exception as exc:  # noqa: BLE001 - any failure of the request
        raise CloudError(f"{method} {url} failed: {exc}") from exc


def _as_json(data) -> Dict:
    """A transport body decoded as JSON (a dict passes as it is)."""
    if isinstance(data, dict):
        return data
    if isinstance(data, (bytes, bytearray)):
        if not data:
            return {}
        try:
            return json.loads(data)
        except json.JSONDecodeError:
            return {"raw": bytes(data).decode("utf-8", "replace")}
    if isinstance(data, str):
        try:
            return json.loads(data) if data else {}
        except json.JSONDecodeError:
            return {"raw": data}
    return {}


def _as_bytes(data) -> bytes:
    """A transport body as bytes (never through a text decode)."""
    if isinstance(data, (bytes, bytearray)):
        return bytes(data)
    if isinstance(data, str):
        return data.encode()
    if isinstance(data, dict):
        raw = data.get("raw", b"")
        return raw.encode() if isinstance(raw, str) else bytes(raw)
    return b""


# -- providers ---------------------------------------------------------------------------

@dataclass
class InstanceSpec:
    """What to rent ('RTX4090', 'A100', ...)."""

    accelerator: str = "RTX4090"
    count: int = 1
    max_usd_per_hour: float = 1.0
    disk_gb: int = 60
    image: str = "framewright/worker:latest"
    region: Optional[str] = None
    env: Dict[str, str] = field(default_factory=dict)


@dataclass
class CloudInstance:
    provider: str
    instance_id: str
    status: str = "provisioning"      # provisioning | running | stopped | failed
    usd_per_hour: float = 0.0
    started_at: float = 0.0
    meta: Dict = field(default_factory=dict)

    def cost_so_far(self, now: Optional[float] = None) -> float:
        if not self.started_at:
            return 0.0
        hours = ((now or time.time()) - self.started_at) / 3600.0
        return round(hours * self.usd_per_hour, 4)


class CloudProvider(ABC):
    """The lifecycle of rented instances."""

    name = "abstract"
    # seconds between the burst's status reads of a running fleet (each
    # read of a remote instance is a request)
    status_poll_s = 30.0

    def __init__(self, api_key: str = "", transport: Optional[Transport] = None):
        self.api_key = api_key
        self.transport = transport or _urllib_transport

    @abstractmethod
    def provision(self, spec: InstanceSpec) -> CloudInstance: ...

    @abstractmethod
    def status(self, instance: CloudInstance) -> str: ...

    @abstractmethod
    def terminate(self, instance: CloudInstance) -> None: ...

    def exit_report(self, instance: CloudInstance) -> str:
        """What is known of a stopped instance's end."""
        return f"{self.name} instance {instance.instance_id} stopped"

    def wait_running(self, instance: CloudInstance, timeout: float = 600.0,
                     poll: float = 5.0) -> CloudInstance:
        t0 = time.time()
        while time.time() - t0 < timeout:
            st = self.status(instance)
            instance.status = st
            if st == "running":
                if not instance.started_at:
                    instance.started_at = time.time()
                return instance
            if st == "failed":
                raise CloudError(f"{self.name} instance {instance.instance_id} failed")
            time.sleep(poll)
        raise CloudError(f"timeout waiting for {instance.instance_id}")


class RunPodProvider(CloudProvider):
    """RunPod's GraphQL API: values travel as GraphQL variables, the key in
    a header."""

    name = "runpod"
    endpoint = "https://api.runpod.io/graphql"

    def _gql(self, query: str, variables: Optional[Dict] = None) -> Dict:
        status, raw = self.transport(
            "POST", self.endpoint,
            {"Content-Type": "application/json", "Authorization": f"Bearer {self.api_key}"},
            json.dumps({"query": query, "variables": variables or {}}).encode())
        data = _as_json(raw)
        if status != 200 or "errors" in data:
            raise CloudError(f"runpod API error ({status}): {data}")
        return data.get("data", {})

    def provision(self, spec: InstanceSpec) -> CloudInstance:
        q = ("mutation Deploy($input: PodFindAndDeployOnDemandInput) {"
             " podFindAndDeployOnDemand(input: $input)"
             " { id costPerHr desiredStatus } }")
        variables = {"input": {
            "cloudType": "COMMUNITY",
            "gpuCount": spec.count,
            "volumeInGb": spec.disk_gb,
            "containerDiskInGb": 10,
            "gpuTypeId": spec.accelerator,
            "name": "framewright-burst",
            "imageName": spec.image,
            "env": [{"key": k, "value": v} for k, v in spec.env.items()],
        }}
        data = self._gql(q, variables)
        pod = data.get("podFindAndDeployOnDemand") or {}
        if not pod.get("id"):
            raise CloudError(f"runpod returned no pod: {data}")
        return CloudInstance(self.name, pod["id"], usd_per_hour=float(pod.get("costPerHr", 0.0)))

    def status(self, instance: CloudInstance) -> str:
        data = self._gql("query Pod($input: PodFilter) { pod(input: $input)"
                         " { desiredStatus runtime { uptimeInSeconds } } }",
                         {"input": {"podId": instance.instance_id}})
        pod = data.get("pod") or {}
        st = (pod.get("desiredStatus") or "").upper()
        if st == "RUNNING" and (pod.get("runtime") or {}).get("uptimeInSeconds"):
            return "running"
        if st in ("EXITED", "TERMINATED"):
            return "stopped"
        return "provisioning"

    def terminate(self, instance: CloudInstance) -> None:
        self._gql("mutation Terminate($input: PodTerminateInput!)"
                  " { podTerminate(input: $input) }",
                  {"input": {"podId": instance.instance_id}})
        instance.status = "stopped"


class VastAIProvider(CloudProvider):
    """Vast.ai's REST API: search the offers, rent the cheapest match,
    destroy it when done."""

    name = "vastai"
    endpoint = "https://console.vast.ai/api/v0"

    def _call(self, method: str, path: str, body: Optional[Dict] = None) -> Dict:
        status, raw = self.transport(
            method, f"{self.endpoint}{path}",
            {"Content-Type": "application/json", "Authorization": f"Bearer {self.api_key}"},
            json.dumps(body).encode() if body is not None else None)
        data = _as_json(raw)
        if status not in (200, 201):
            raise CloudError(f"vast.ai API error ({status}): {data}")
        return data

    def search_offers(self, spec: InstanceSpec) -> List[Dict]:
        q = {"gpu_name": {"eq": spec.accelerator}, "num_gpus": {"gte": spec.count},
             "dph_total": {"lte": spec.max_usd_per_hour}, "rentable": {"eq": True}}
        data = self._call("GET", "/bundles/", {"q": q, "order": [["dph_total", "asc"]],
                                               "limit": 16})
        return data.get("offers", [])

    def provision(self, spec: InstanceSpec) -> CloudInstance:
        offers = self.search_offers(spec)
        if not offers:
            raise CloudError(f"no vast.ai offers for {spec.accelerator} "
                             f"<= ${spec.max_usd_per_hour}/h")
        offer = offers[0]
        data = self._call("PUT", f"/asks/{offer['id']}/", {
            "client_id": "me", "image": spec.image, "disk": spec.disk_gb, "env": spec.env})
        if not data.get("success"):
            raise CloudError(f"vast.ai rent failed: {data}")
        return CloudInstance(self.name, str(data.get("new_contract")),
                             usd_per_hour=float(offer.get("dph_total", 0.0)))

    def status(self, instance: CloudInstance) -> str:
        data = self._call("GET", f"/instances/{instance.instance_id}/")
        st = (data.get("instances") or data).get("actual_status") or ""
        return {"running": "running", "exited": "stopped", "created": "provisioning",
                "loading": "provisioning"}.get(st, "provisioning")

    def terminate(self, instance: CloudInstance) -> None:
        self._call("DELETE", f"/instances/{instance.instance_id}/")
        instance.status = "stopped"


def _refuse_http(*_args):
    raise CloudError("local provider makes no HTTP calls")


class LocalSubprocessProvider(CloudProvider):
    """Farm workers as processes on this host, the burst target that needs
    no account: each runs ``farm work JOB_DIR --device DEVICE`` with the
    caller's environment and ``spec.env`` over it, its stdout and stderr
    in ``JOB_DIR/workers/worker_<k>.out`` and ``.err``. ``terminate`` gives
    a live worker ``exit_grace_s`` to exit by itself first."""

    name = "local"
    status_poll_s = 0.0
    # seconds a live worker is given to exit by itself before it is
    # terminated (a worker exits once every chunk has a result)
    exit_grace_s = 10.0

    def __init__(self, job_dir: Optional[Path] = None, device: str = "cuda"):
        super().__init__("", _refuse_http)
        self.job_dir = job_dir
        self.device = device
        self._procs: Dict[str, subprocess.Popen] = {}
        self._logs: Dict[str, Tuple[Path, Path]] = {}
        self._lock = threading.Lock()

    def command(self, spec: InstanceSpec) -> List[str]:
        """A worker's argv."""
        return [sys.executable, "-m", "framewright_tpu_torch.cli", "farm", "work",
                str(self.job_dir), "--device", self.device]

    def provision(self, spec: InstanceSpec) -> CloudInstance:
        if self.job_dir is None:
            raise CloudError("LocalSubprocessProvider needs a job_dir")
        logs = Path(self.job_dir) / "workers"
        logs.mkdir(parents=True, exist_ok=True)
        with self._lock:
            k = sum(1 for _ in logs.glob("worker_*.err"))
            out, err = logs / f"worker_{k}.out", logs / f"worker_{k}.err"
            err.touch()
        env = {**os.environ, **spec.env}
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (str(_PACKAGE_ROOT), env.get("PYTHONPATH", "")) if p)
        with open(out, "wb") as fo, open(err, "wb") as fe:
            proc = subprocess.Popen(self.command(spec), stdin=subprocess.DEVNULL,
                                    stdout=fo, stderr=fe, env=env)
        inst = CloudInstance(self.name, str(proc.pid), status="running",
                             started_at=time.time(), meta={"stdout": str(out), "stderr": str(err)})
        self._procs[inst.instance_id] = proc
        self._logs[inst.instance_id] = (out, err)
        return inst

    def status(self, instance: CloudInstance) -> str:
        proc = self._procs.get(instance.instance_id)
        if proc is None:
            return "stopped"
        return "running" if proc.poll() is None else "stopped"

    def exit_report(self, instance: CloudInstance, tail: int = 800) -> str:
        proc = self._procs.get(instance.instance_id)
        code = proc.poll() if proc is not None else None
        err = instance.meta.get("stderr")
        text = ""
        if err and Path(err).exists():
            text = Path(err).read_bytes()[-tail:].decode("utf-8", "replace").strip()
        return f"worker pid {instance.instance_id} exited with {code}: {text or '(no stderr)'}"

    def terminate(self, instance: CloudInstance) -> None:
        proc = self._procs.pop(instance.instance_id, None)
        if proc is not None and proc.poll() is None:
            try:
                proc.wait(timeout=self.exit_grace_s)
            except subprocess.TimeoutExpired:
                pass
        if proc is not None and proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        instance.status = "stopped"


def provider_for(name: str, job_dir: Optional[Path] = None, api_key: str = "",
                 device: str = "cuda") -> CloudProvider:
    """The provider a ``--burst`` name selects; ``gcp-tpu`` (JAX's
    ``TPUPodProvider``) is refused: a TPU VM has no CUDA card."""
    from framewright_tpu_torch.errors import ConfigError

    if name == "gcp-tpu":
        raise ConfigError("--burst gcp-tpu rents a TPU VM, which has no CUDA card for the "
                          "port's workers; use local, runpod or vastai")
    if name not in PROVIDERS:
        raise ConfigError(f"unknown burst provider {name!r}; one of {sorted(PROVIDERS)}")
    if name == "local":
        return LocalSubprocessProvider(job_dir=job_dir, device=device)
    return PROVIDERS[name](api_key=api_key)


PROVIDERS = {
    "runpod": RunPodProvider,
    "vastai": VastAIProvider,
    "local": LocalSubprocessProvider,
}


# -- storage ------------------------------------------------------------------------------

class CloudStorage(ABC):
    @abstractmethod
    def upload(self, local: Path, remote_key: str) -> None: ...

    @abstractmethod
    def download(self, remote_key: str, local: Path) -> None: ...

    @abstractmethod
    def exists(self, remote_key: str) -> bool: ...


class LocalDirStorage(CloudStorage):
    """A shared directory (an NFS or gcsfuse mount; the burst's job
    directory)."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def upload(self, local: Path, remote_key: str) -> None:
        dst = self.root / remote_key
        dst.parent.mkdir(parents=True, exist_ok=True)
        tmp = dst.with_suffix(dst.suffix + ".tmp")
        shutil.copyfile(local, tmp)
        tmp.rename(dst)

    def download(self, remote_key: str, local: Path) -> None:
        local.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(self.root / remote_key, local)

    def exists(self, remote_key: str) -> bool:
        return (self.root / remote_key).exists()


def sigv4_headers(method: str, url: str, region: str, service: str, access_key: str,
                  secret_key: str, payload: bytes, amz_date: str) -> Dict[str, str]:
    """AWS Signature Version 4 with hmac and hashlib; ``amz_date`` is
    'YYYYMMDDTHHMMSSZ'. The URL's path is signed in its once-encoded form,
    the query's pairs encoded and sorted."""
    parsed = urllib.parse.urlparse(url)
    host = parsed.netloc
    canonical_uri = urllib.parse.quote(parsed.path or "/", safe="/%")
    if parsed.query:
        pairs = urllib.parse.parse_qsl(parsed.query, keep_blank_values=True)
        enc = [(urllib.parse.quote(k, safe="-_.~"), urllib.parse.quote(v, safe="-_.~"))
               for k, v in pairs]
        canonical_query = "&".join(f"{k}={v}" for k, v in sorted(enc))
    else:
        canonical_query = ""
    payload_hash = hashlib.sha256(payload).hexdigest()
    datestamp = amz_date[:8]
    canonical_headers = (f"host:{host}\nx-amz-content-sha256:{payload_hash}\n"
                         f"x-amz-date:{amz_date}\n")
    signed_headers = "host;x-amz-content-sha256;x-amz-date"
    canonical_request = "\n".join([method, canonical_uri, canonical_query, canonical_headers,
                                   signed_headers, payload_hash])
    scope = f"{datestamp}/{region}/{service}/aws4_request"
    string_to_sign = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                                hashlib.sha256(canonical_request.encode()).hexdigest()])

    def _hmac(key: bytes, msg: str) -> bytes:
        return hmac.new(key, msg.encode(), hashlib.sha256).digest()

    k = _hmac(("AWS4" + secret_key).encode(), datestamp)
    k = _hmac(k, region)
    k = _hmac(k, service)
    k = _hmac(k, "aws4_request")
    signature = hmac.new(k, string_to_sign.encode(), hashlib.sha256).hexdigest()
    return {
        "x-amz-date": amz_date,
        "x-amz-content-sha256": payload_hash,
        "Authorization": (f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
                          f"SignedHeaders={signed_headers}, Signature={signature}"),
    }


class S3Storage(CloudStorage):
    """S3's REST API signed with SigV4 in-process."""

    def __init__(self, bucket: str, region: str = "us-east-1", access_key: str = "",
                 secret_key: str = "", transport: Optional[Transport] = None,
                 now: Optional[Callable[[], str]] = None):
        self.bucket = bucket
        self.region = region
        self.access_key = access_key
        self.secret_key = secret_key
        self.transport = transport or _urllib_transport
        self.now = now or (lambda: time.strftime("%Y%m%dT%H%M%SZ", time.gmtime()))

    def _url(self, key: str) -> str:
        return f"https://{self.bucket}.s3.{self.region}.amazonaws.com/{urllib.parse.quote(key)}"

    def _request(self, method: str, key: str, payload: bytes = b"") -> Tuple[int, object]:
        url = self._url(key)
        headers = sigv4_headers(method, url, self.region, "s3", self.access_key,
                                self.secret_key, payload, self.now())
        return self.transport(method, url, headers, payload or None)

    def upload(self, local: Path, remote_key: str) -> None:
        status, data = self._request("PUT", remote_key, Path(local).read_bytes())
        if status != 200:
            raise CloudError(f"S3 upload {remote_key} failed ({status}): {data}")

    def download(self, remote_key: str, local: Path) -> None:
        status, data = self._request("GET", remote_key)
        if status != 200:
            raise CloudError(f"S3 download {remote_key} failed ({status})")
        Path(local).parent.mkdir(parents=True, exist_ok=True)
        Path(local).write_bytes(_as_bytes(data))

    def exists(self, remote_key: str) -> bool:
        status, _ = self._request("HEAD", remote_key)
        return status == 200


class GCSStorage(CloudStorage):
    """GCS's JSON API with a bearer token."""

    def __init__(self, bucket: str, token: str = "", transport: Optional[Transport] = None):
        self.bucket = bucket
        self.token = token
        self.transport = transport or _urllib_transport

    def _headers(self) -> Dict[str, str]:
        return {"Authorization": f"Bearer {self.token}"}

    def _object_url(self, remote_key: str) -> str:
        return (f"https://storage.googleapis.com/storage/v1/b/{self.bucket}"
                f"/o/{urllib.parse.quote(remote_key, safe='')}")

    def upload(self, local: Path, remote_key: str) -> None:
        url = (f"https://storage.googleapis.com/upload/storage/v1/b/{self.bucket}"
               f"/o?uploadType=media&name={urllib.parse.quote(remote_key, safe='')}")
        status, data = self.transport("POST", url, self._headers(), Path(local).read_bytes())
        if status != 200:
            raise CloudError(f"GCS upload failed ({status}): {data}")

    def download(self, remote_key: str, local: Path) -> None:
        status, data = self.transport("GET", self._object_url(remote_key) + "?alt=media",
                                      self._headers(), None)
        if status != 200:
            raise CloudError(f"GCS download failed ({status})")
        Path(local).parent.mkdir(parents=True, exist_ok=True)
        Path(local).write_bytes(_as_bytes(data))

    def exists(self, remote_key: str) -> bool:
        status, _ = self.transport("GET", self._object_url(remote_key), self._headers(), None)
        return status == 200


class AzureBlobStorage(CloudStorage):
    """Azure Blob's REST API signed with SharedKey in-process. A PUT pins
    and signs an ``application/octet-stream`` Content-Type (urllib adds
    one to any request with a body, and an unsigned one is refused)."""

    _VERSION = "2021-08-06"

    def __init__(self, account: str, container: str, account_key: str = "",
                 transport: Optional[Transport] = None,
                 now: Optional[Callable[[], str]] = None):
        self.account = account
        self.container = container
        self.account_key = account_key
        self.transport = transport or _urllib_transport
        self.now = now or (lambda: time.strftime("%a, %d %b %Y %H:%M:%S GMT", time.gmtime()))

    def _url(self, key: str) -> str:
        return (f"https://{self.account}.blob.core.windows.net/"
                f"{self.container}/{urllib.parse.quote(key)}")

    def _headers(self, method: str, key: str, payload: bytes) -> Dict[str, str]:
        xms = {"x-ms-blob-type": "BlockBlob", "x-ms-date": self.now(),
               "x-ms-version": self._VERSION}
        if method != "PUT":
            xms.pop("x-ms-blob-type")
        length = str(len(payload)) if payload else ""
        content_type = "application/octet-stream" if method == "PUT" else ""
        canon_headers = "".join(f"{k}:{v}\n" for k, v in sorted(xms.items()))
        canon_resource = f"/{self.account}/{self.container}/{urllib.parse.quote(key)}"
        string_to_sign = "\n".join([method, "", "", length, "", content_type,
                                    "", "", "", "", "", ""]) + "\n" + canon_headers \
            + canon_resource
        signature = base64.b64encode(hmac.new(
            base64.b64decode(self.account_key or b"AA=="), string_to_sign.encode(),
            hashlib.sha256).digest()).decode()
        headers = {**xms, "Authorization": f"SharedKey {self.account}:{signature}"}
        if content_type:
            headers["Content-Type"] = content_type
        return headers

    def upload(self, local: Path, remote_key: str) -> None:
        payload = Path(local).read_bytes()
        status, data = self.transport("PUT", self._url(remote_key),
                                      self._headers("PUT", remote_key, payload), payload)
        if status not in (200, 201):
            raise CloudError(f"Azure upload {remote_key} failed ({status}): {data}")

    def download(self, remote_key: str, local: Path) -> None:
        status, data = self.transport("GET", self._url(remote_key),
                                      self._headers("GET", remote_key, b""), None)
        if status != 200:
            raise CloudError(f"Azure download {remote_key} failed ({status})")
        Path(local).parent.mkdir(parents=True, exist_ok=True)
        Path(local).write_bytes(_as_bytes(data))

    def exists(self, remote_key: str) -> bool:
        status, _ = self.transport("HEAD", self._url(remote_key),
                                   self._headers("HEAD", remote_key, b""), None)
        return status == 200


class GoogleDriveStorage(CloudStorage):
    """Google Drive v3 with an OAuth bearer token; ``remote_key`` is a file
    name in ``folder_id``. A repeated upload updates the file of that name
    in place (Drive allows two files of one name in a folder)."""

    _API = "https://www.googleapis.com/drive/v3"
    _UPLOAD = "https://www.googleapis.com/upload/drive/v3"

    def __init__(self, token: str = "", folder_id: str = "root",
                 transport: Optional[Transport] = None):
        self.token = token
        self.folder_id = folder_id
        self.transport = transport or _urllib_transport

    def _headers(self, extra: Optional[Dict[str, str]] = None) -> Dict[str, str]:
        return {"Authorization": f"Bearer {self.token}", **(extra or {})}

    def _find(self, remote_key: str) -> Optional[str]:
        name = remote_key.replace("'", "\\'")
        q = urllib.parse.quote(f"name = '{name}' and '{self.folder_id}' in parents "
                               f"and trashed = false")
        status, data = self.transport("GET", f"{self._API}/files?q={q}&fields=files(id,name)",
                                      self._headers(), None)
        if status != 200:
            raise CloudError(f"GDrive list failed ({status}): {data}")
        files = _as_json(data).get("files", [])
        return files[0]["id"] if files else None

    def upload(self, local: Path, remote_key: str) -> None:
        existing = self._find(remote_key)
        if existing is not None:
            status, data = self.transport(
                "PATCH", f"{self._UPLOAD}/files/{existing}?uploadType=media",
                self._headers({"Content-Type": "application/octet-stream"}),
                Path(local).read_bytes())
            if status != 200:
                raise CloudError(f"GDrive update failed ({status}): {data}")
            return
        boundary = "fw-boundary-7b3d"
        meta = json.dumps({"name": remote_key, "parents": [self.folder_id]})
        body = (f"--{boundary}\r\n"
                "Content-Type: application/json; charset=UTF-8\r\n\r\n"
                f"{meta}\r\n"
                f"--{boundary}\r\n"
                "Content-Type: application/octet-stream\r\n\r\n").encode() \
            + Path(local).read_bytes() + f"\r\n--{boundary}--".encode()
        status, data = self.transport(
            "POST", f"{self._UPLOAD}/files?uploadType=multipart",
            self._headers({"Content-Type": f"multipart/related; boundary={boundary}"}), body)
        if status != 200:
            raise CloudError(f"GDrive upload failed ({status}): {data}")

    def download(self, remote_key: str, local: Path) -> None:
        fid = self._find(remote_key)
        if fid is None:
            raise CloudError(f"GDrive: {remote_key!r} not found")
        status, data = self.transport("GET", f"{self._API}/files/{fid}?alt=media",
                                      self._headers(), None)
        if status != 200:
            raise CloudError(f"GDrive download failed ({status})")
        Path(local).parent.mkdir(parents=True, exist_ok=True)
        Path(local).write_bytes(_as_bytes(data))

    def exists(self, remote_key: str) -> bool:
        return self._find(remote_key) is not None


# -- the burst ----------------------------------------------------------------------------

@dataclass
class BurstPolicy:
    """When to burst and how much."""

    max_instances: int = 4
    min_chunks_per_instance: int = 2       # no rent for tiny jobs
    budget_usd: float = 10.0
    local_fps_threshold: float = 0.0       # burst when the local fps is below this


class CloudBurstManager:
    """Split a restore into chunks, run them on rented instances, merge.

    The source and the job go to the shared directory, the fleet is sized
    to the chunks and provisioned, the coordinator waits for the parts
    (the farm's protocol, ``parallel/multihost``) and merges them; the
    instances are always terminated."""

    def __init__(self, provider: CloudProvider, storage: CloudStorage,
                 policy: Optional[BurstPolicy] = None):
        self.provider = provider
        self.storage = storage
        self.policy = policy or BurstPolicy()
        self.instances: List[CloudInstance] = []
        self._lock = threading.Lock()

    def should_burst(self, total_chunks: int, local_fps: float = 1e9) -> bool:
        p = self.policy
        if total_chunks < 2 * p.min_chunks_per_instance:
            return False
        if local_fps < p.local_fps_threshold:
            return True
        return total_chunks >= 2 * p.min_chunks_per_instance

    def instances_for(self, total_chunks: int) -> int:
        p = self.policy
        return max(1, min(p.max_instances, total_chunks // p.min_chunks_per_instance))

    def provision_fleet(self, spec: InstanceSpec, n: int) -> List[CloudInstance]:
        for _ in range(n):
            est = sum(i.usd_per_hour for i in self.instances)
            if est + spec.max_usd_per_hour > self.policy.budget_usd:
                logger.warning("burst budget reached at %d instances", len(self.instances))
                break
            inst = self.provider.provision(spec)
            with self._lock:
                self.instances.append(inst)
        return self.instances

    def teardown(self) -> float:
        """Terminate every instance; the estimated cost."""
        cost = 0.0
        with self._lock:
            insts, self.instances = self.instances, []
        for inst in insts:
            cost += inst.cost_so_far()
            try:
                self.provider.terminate(inst)
            except CloudError:
                logger.exception("terminate %s failed", inst.instance_id)
        return round(cost, 4)

    def _fleet_watch(self, coord, n_chunks: int) -> Callable[[Dict[int, str]], None]:
        """The coordinator's per-poll hook: ``CloudError`` naming each
        instance's end once every instance has stopped while chunks remain
        (read at most every ``provider.status_poll_s`` seconds)."""
        last = [float("-inf")]

        def watch(_status: Dict[int, str]) -> None:
            now = time.monotonic()
            if not self.instances or now - last[0] < self.provider.status_poll_s:
                return
            last[0] = now
            if any(self.provider.status(i) != "stopped" for i in self.instances):
                return
            # every instance has stopped: read the results they left
            if coord.is_complete(n_chunks):
                return
            coord.check_failures(n_chunks)
            ends = "; ".join(self.provider.exit_report(i) for i in self.instances)
            raise CloudError(f"every burst instance stopped with chunks left "
                             f"({coord.chunk_status(n_chunks)}): {ends}",
                             details={"instances": [i.instance_id for i in self.instances]})

        return watch

    def run(self, source: Path, output: Path, total_frames: int,
            config: Optional[Dict] = None, spec: Optional[InstanceSpec] = None,
            chunk_frames: int = 100, timeout: float = 3600.0, poll_s: float = 1.0) -> Path:
        """The whole burst: stage the source, publish the job, provision
        the fleet, wait for the parts and merge, always tearing down."""
        from framewright_tpu_torch.parallel.multihost import (
            RenderJob,
            SharedDirCoordinator,
            run_coordinator,
        )

        if not isinstance(self.storage, LocalDirStorage):
            raise CloudError("burst execution needs LocalDirStorage (a shared mount); "
                             "S3, GCS, Azure and Drive storages upload and download only")
        job_dir = self.storage.root
        self.storage.upload(Path(source), "source.y4m")
        job = RenderJob(job_id="burst", source=str(job_dir / "source.y4m"),
                        output=str(job_dir / "merged.y4m"), config=config or {},
                        total_frames=total_frames, chunk_frames=chunk_frames)
        coord = SharedDirCoordinator(job_dir)
        coord.submit(job)
        if isinstance(self.provider, LocalSubprocessProvider):
            self.provider.job_dir = job_dir
        n_chunks = len(job.chunks())
        try:
            self.provision_fleet(spec or InstanceSpec(), self.instances_for(n_chunks))
            if not self.instances:
                raise CloudError(f"the burst budget (${self.policy.budget_usd}) admits no "
                                 f"instance at ${(spec or InstanceSpec()).max_usd_per_hour}/h")
            merged = run_coordinator(job_dir, job, timeout=timeout, poll_s=poll_s,
                                     progress=self._fleet_watch(coord, n_chunks))
            shutil.copyfile(merged, output)
            return Path(output)
        finally:
            cost = self.teardown()
            logger.info("burst complete; estimated cost $%.4f", cost)
