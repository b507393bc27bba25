"""The port's uploaders and notification routing
(``framewright_tpu_torch/uploads.py``) against the JAX package's, on the
CPU with fake transports: every case of ``tests/test_uploads.py`` on the
port, each request equal to JAX's (method, URL, headers and body bytes;
the port hands the archive.org PUT the open file, whose bytes are
compared); the streamed read that the port keeps where JAX reads the
whole video into memory; ``NotificationRouter``'s sends on its own bus;
the ``upload`` verb's JSON; ``_header_aware_transport`` against an
``http.server`` on 127.0.0.1. Nothing leaves the host."""

from __future__ import annotations

import contextlib
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer
from pathlib import Path

import pytest

from framewright_tpu import cli as jcli
from framewright_tpu import events as jevents
from framewright_tpu import uploads as juploads
from framewright_tpu_torch import cli, events, uploads


class FakeTransport:
    """Scripted replies; a body that is a file is read the way http.client
    sends one (blocks of 8192 bytes) and recorded as its bytes."""

    def __init__(self, script):
        self.script = list(script)
        self.calls = []

    def __call__(self, method, url, headers, body):
        if hasattr(body, "read"):
            body = b"".join(iter(lambda: body.read(8192), b""))
        self.calls.append((method, url, dict(headers), body))
        return self.script.pop(0)


@pytest.fixture()
def video(tmp_path):
    p = tmp_path / "out.y4m"
    p.write_bytes(b"YUV4MPEG2 fake video payload " * 100)
    return p


def both(make, *args):
    """``make(mod, *args)`` for JAX's module and the port's: (jax, port)."""
    return make(juploads, *args), make(uploads, *args)


# -- archive.org -------------------------------------------------------------------------

def test_metadata_validation():
    for mod in (juploads, uploads):
        assert len(mod.ArchiveMetadata(identifier="x", title="").validate()) == 2
        assert mod.ArchiveMetadata(identifier="a b!", title="T").validate() == [
            "identifier may use only [a-zA-Z0-9-_.]"]
        assert not mod.ArchiveMetadata(identifier="my-film_1936", title="Film").validate()
        assert mod.YouTubeMetadata(title="x" * 101, privacy="everyone").validate() == \
            ["title required, <= 100 chars", "privacy must be private|unlisted|public"]


def _archive(mod, video, status=200):
    t = FakeTransport([(status, b"")])
    meta = mod.ArchiveMetadata(identifier="my-film", title="My Film", description="D",
                               creator="Me", date="1936", license_url="http://l",
                               subjects=["silent", "16mm"])
    r = mod.ArchiveUploader("AK", "SK", transport=t).upload(video, meta)
    return (r.ok, r.url, r.item_id, r.error), t


@pytest.mark.parametrize("status", [200, 201, 500])
def test_archive_upload_requests_equal_jax(video, status):
    (jres, jt), (res, t) = both(_archive, video, status)
    assert t.calls == jt.calls and res == jres
    method, url, headers, body = t.calls[0]
    assert method == "PUT" and url == "https://s3.us.archive.org/my-film/out.y4m"
    assert headers["authorization"] == "LOW AK:SK"
    assert headers["x-archive-meta-title"] == "My Film"
    assert headers["x-archive-meta01-subject"] == "silent"
    assert body == video.read_bytes()
    assert res == ((True, "https://archive.org/details/my-film", "my-film", "")
                   if status < 300 else (False, "", "", "IAS3 PUT returned 500"))


def test_archive_refusals_equal_jax(video, tmp_path):
    for args, meta in ((("", ""), ("abc", "T")), (("a", "s"), ("x", "")),
                       (("a", "s"), ("abc", "T"))):
        path = video if meta != ("abc", "T") or args == ("", "") else tmp_path / "none.y4m"
        (jr, _), (r, t) = both(lambda mod: (mod.ArchiveUploader(
            *args, transport=FakeTransport([])).upload(path, mod.ArchiveMetadata(*meta)),
            None))
        assert (r.ok, r.error) == (jr.ok, jr.error) and not r
    assert "keys" in uploads.ArchiveUploader(transport=FakeTransport([])).upload(
        video, uploads.ArchiveMetadata("abc", "T")).error


def _identifier(mod):
    taken = FakeTransport([(200, {"metadata": {"title": "x"}})])
    free = FakeTransport([(404, b"")])
    status = FakeTransport([(200, {"metadata": {"t": 1}, "files": [1, 2]}), (404, b"")])
    up = mod.ArchiveUploader("a", "s", transport=status)
    out = (mod.ArchiveUploader("a", "s", transport=taken).check_identifier_available("x"),
           mod.ArchiveUploader("a", "s", transport=free).check_identifier_available("y"),
           up.get_upload_status("x"), up.get_upload_status("y"))
    return out, taken.calls + free.calls + status.calls


def test_identifier_availability_and_status():
    (jres, jcalls), (res, calls) = both(_identifier)
    assert calls == jcalls and res == jres
    assert res == (False, True, {"exists": True, "files": 2}, {"exists": False})


# -- YouTube -----------------------------------------------------------------------------

def _youtube(mod, video, script, chunk=None):
    t = FakeTransport(script)
    up = mod.YouTubeUploader("TOKEN", transport=t)
    if chunk is not None:
        up.CHUNK = chunk
    r = up.upload(video, mod.YouTubeMetadata(title="Restored", description="d",
                                             tags=["a", "b"], privacy="unlisted"))
    return (r.ok, r.url, r.item_id, r.error), t


@pytest.mark.parametrize("script,chunk", [
    ([(200, {"location": "https://upload.example/session1"}), (200, {"id": "vid123"})], None),
    ([(200, {"location": "https://u/session"}), (308, b""), (200, {"id": "v2"})], 1501),
    ([(200, {"location": "https://u/s"}), (308, b""), (308, b""), (201, {"id": "v3"})], 1000),
    ([(200, {"location": "https://u/s"}), (308, b""), (503, b"")], 1000),
    ([(200, {})], None),
    ([(403, b"")], None),
    ([(200, {"location": "https://u/s"}), (200, {})], None),
], ids=["one-put", "308", "three-chunks", "chunk-fails", "no-session", "open-fails", "no-id"])
def test_youtube_upload_requests_equal_jax(video, script, chunk):
    (jres, jt), (res, t) = both(_youtube, video, script, chunk)
    assert t.calls == jt.calls and res == jres
    if res[0]:
        assert t.calls[1][2]["content-range"].startswith("bytes 0-")
        assert res[1] == f"https://youtu.be/{res[2]}"
        assert json.loads(t.calls[0][3])["status"]["privacyStatus"] == "unlisted"


def test_youtube_token_refresh_and_refusals(video):
    (jok, jt), (ok, t) = both(lambda mod: (mod.YouTubeUploader(transport=(tr := FakeTransport(
        [(200, {"access_token": "fresh"})]))).refresh_access_token("cid", "sec", "rtok"), tr))
    assert ok is jok is True and t.calls == jt.calls
    assert "grant_type=refresh_token" in t.calls[0][3].decode()
    for mod in (juploads, uploads):
        up = mod.YouTubeUploader(transport=FakeTransport([(400, {})]))
        assert not up.refresh_access_token("a", "b", "c") and up.access_token == ""
        assert mod.YouTubeUploader(transport=FakeTransport([])).upload(
            video, mod.YouTubeMetadata(title="T")).error == "missing OAuth2 access token"
        r = mod.YouTubeUploader("TOKEN", transport=FakeTransport([])).upload(
            video, mod.YouTubeMetadata(title="x" * 200, privacy="everyone"))
        assert not r and "100 chars" in r.error


# -- the streamed read -------------------------------------------------------------------

class SpyFile(io.FileIO):
    """A file that records the size of every read."""

    reads: list = []

    def read(self, size=-1):
        SpyFile.reads.append(size)
        return super().read(size)


def test_uploads_stream_the_file_where_jax_reads_it_whole(tmp_path, monkeypatch):
    """A video of 10 chunks: the port's YouTube upload reads one chunk at a
    time at its offset, and its archive.org PUT hands the transport the open
    file, which http.client reads in blocks of 8192 bytes; no read asks for
    more than a chunk (8 MiB by default) or for the whole file. JAX's reads
    the whole file into memory for each."""
    video = tmp_path / "big.y4m"
    video.write_bytes(bytes(range(256)) * 40)           # 10240 B, 10 chunks of 1024
    SpyFile.reads = []
    monkeypatch.setattr(uploads, "_open_video", lambda p: SpyFile(p, "rb"))
    script = [(200, {"location": "https://u/s"})] + [(308, b"")] * 9 + [(200, {"id": "v"})]
    t = FakeTransport(script)
    up = uploads.YouTubeUploader("T", transport=t)
    up.CHUNK = 1024
    assert up.upload(video, uploads.YouTubeMetadata(title="T")).ok
    assert SpyFile.reads == [1024] * 10
    assert b"".join(c[3] for c in t.calls[1:]) == video.read_bytes()
    SpyFile.reads = []
    t = FakeTransport([(200, b"")])
    assert uploads.ArchiveUploader("a", "s", transport=t).upload(
        video, uploads.ArchiveMetadata("abc", "T")).ok
    assert SpyFile.reads and max(SpyFile.reads) == 8192 and -1 not in SpyFile.reads
    assert t.calls[0][3] == video.read_bytes()
    # JAX: Path.read_bytes of the whole file, once per upload
    whole = []
    real = Path.read_bytes

    def spy(self):
        data = real(self)
        whole.append(len(data))
        return data

    monkeypatch.setattr(Path, "read_bytes", spy)
    jup = juploads.YouTubeUploader("T", transport=FakeTransport(script))
    jup.CHUNK = 1024
    assert jup.upload(video, juploads.YouTubeMetadata(title="T")).ok
    assert juploads.ArchiveUploader("a", "s", transport=FakeTransport([(200, b"")])).upload(
        video, juploads.ArchiveMetadata("abc", "T")).ok
    assert whole == [10240, 10240]


# -- notifications -----------------------------------------------------------------------

class FakeSMTP:
    instances = []

    def __init__(self, host, port):
        self.host, self.port, self.tls, self.sent = host, port, False, []
        FakeSMTP.instances.append(self)

    def starttls(self):
        self.tls = True

    def login(self, u, p):
        self.creds = (u, p)

    def sendmail(self, frm, to, msg):
        self.sent.append((frm, to, msg))

    def quit(self):
        pass


def _route(mod, evmod):
    FakeSMTP.instances = []
    email = mod.EmailSender(mod.EmailConfig(smtp_host="h", recipients=["x@y.z"],
                                            use_tls=False), smtp_factory=FakeSMTP)
    sms_t = FakeTransport([(200, b""), (500, b""), (200, b"")])
    router = mod.NotificationRouter(email=email, sms_sender=mod.SMSSender(
        "https://gw", api_key="k", transport=sms_t), sms_to="+1555")
    bus = evmod.EventBus()
    router.attach(bus)
    bus.emit(evmod.EventType.JOB_COMPLETED, source="t", job_id="j1", frames=12)
    bus.emit(evmod.EventType.PROGRESS, source="t")
    bus.emit(evmod.EventType.JOB_FAILED, source="t", job_id="j2", error="x" * 600)
    bus.emit(evmod.EventType.JOB_COMPLETED, source="t", job_id="j3")
    mails = [(m[0], m[1], m[2].split("\n\n", 1)[1]) for s in FakeSMTP.instances
             for m in s.sent]
    return router.sent, mails, sms_t.calls


def test_router_sends_equal_jax_on_its_own_bus():
    jres, res = _route(juploads, jevents), _route(uploads, events)
    assert res == jres
    sent, mails, sms = res
    assert sent == ["email:job_completed", "sms:job_completed", "email:job_failed",
                    "email:job_completed", "sms:job_completed"]
    assert len(mails) == 3 and len(sms) == 3
    assert json.loads(sms[0][3])["body"].startswith("[framewright] job_completed: ")


def test_email_and_sms_send():
    FakeSMTP.instances = []
    sender = uploads.EmailSender(uploads.EmailConfig(
        smtp_host="smtp.test", username="u@test", password="pw", recipients=["a@b.c"]),
        smtp_factory=FakeSMTP)
    assert sender.send("done", "job finished")
    smtp = FakeSMTP.instances[0]
    assert smtp.tls and smtp.creds == ("u@test", "pw") and smtp.sent[0][1] == ["a@b.c"]
    t = FakeTransport([(200, b"")])
    assert uploads.SMSSender("https://gw.test/send", api_key="k", transport=t).send(
        "+15550100", "job complete")
    assert t.calls[0][2]["authorization"] == "Bearer k"
    assert json.loads(t.calls[0][3])["to"] == "+15550100"


# -- the upload verb ---------------------------------------------------------------------

def run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("argv,archive,youtube", [
    (["upload", "archive", "{v}", "--access-key", "AK", "--secret-key", "SK",
      "--title", "T", "--creator", "C"], [(200, b"")], []),
    (["upload", "archive", "{v}"], [], []),
    (["upload", "archive", "{v}", "--access-key", "AK", "--secret-key", "SK",
      "--identifier", "x"], [], []),
    (["upload", "youtube", "{v}", "--access-token", "TOK", "--privacy", "public"], [],
     [(200, {"location": "https://u/s"}), (200, {"id": "vid9"})]),
    (["upload", "youtube", "{v}", "--refresh-token", "R", "--client-id", "C",
      "--client-secret", "S"], [],
     [(200, {"access_token": "fresh"}), (200, {"location": "https://u/s"}),
      (200, {"id": "vid8"})]),
    (["upload", "youtube", "{v}"], [], []),
], ids=["archive", "archive-no-keys", "archive-bad-id", "youtube", "youtube-refresh",
        "youtube-no-token"])
def test_upload_verb_prints_jax_json(video, monkeypatch, argv, archive, youtube):
    """The verb's JSON and return code equal JAX's, with both packages'
    default transports replaced by the same script."""
    argv = [a.format(v=video) for a in argv]
    results = []
    for main, mod in ((jcli.main, juploads), (cli.main, uploads)):
        ta, ty = FakeTransport(archive), FakeTransport(youtube)
        monkeypatch.setattr(mod, "_urllib_transport", ta)
        monkeypatch.setattr(mod, "_header_aware_transport", ty)
        results.append((run(main, argv), ta.calls, ty.calls))
    assert results[1] == results[0]
    (rc, out, err), _, _ = results[1]
    doc = json.loads(out)
    assert rc == (0 if doc["ok"] else 1) and err == ""
    assert set(doc) == {"ok", "url", "error"}


# -- the header-aware transport on 127.0.0.1 ---------------------------------------------

class _Handler(BaseHTTPRequestHandler):
    seen = []

    def log_message(self, *args):
        pass

    def _reply(self):
        n = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(n) if n else b""
        _Handler.seen.append((self.command, self.path, self.headers.get("Content-Length"),
                              self.headers.get("Transfer-Encoding"), body))
        payload = json.dumps({"got": len(body)}).encode()
        self.send_response(200 if self.path != "/missing" else 404)
        if self.path == "/session":
            self.send_header("Location", "http://127.0.0.1/upload/abc")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    do_POST = do_PUT = do_GET = _reply


@pytest.fixture()
def server():
    _Handler.seen = []
    srv = HTTPServer(("127.0.0.1", 0), _Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    t.join()
    srv.server_close()


def test_header_aware_transport_on_a_local_server(server, video):
    """The Location header folded into the JSON body as JAX's transport
    does; a file body sent whole with its Content-Length (not chunked);
    an HTTP error raised as UploadError naming the request."""
    for mod in (juploads, uploads):
        status, body = mod._header_aware_transport("POST", f"{server}/session",
                                                   {"content-type": "application/json"},
                                                   b'{"a": 1}')
        assert status == 200 and json.loads(body) == {"got": 8,
                                                      "location": "http://127.0.0.1/upload/abc"}
        status, body = mod._header_aware_transport("GET", f"{server}/plain", {}, None)
        assert status == 200 and json.loads(body) == {"got": 0}
        with pytest.raises(mod.UploadError, match="GET .*/missing failed"):
            mod._header_aware_transport("GET", f"{server}/missing", {}, None)
    with open(video, "rb") as f:
        status, body = uploads._header_aware_transport("PUT", f"{server}/put", {}, f)
    size = video.stat().st_size
    assert status == 200 and json.loads(body) == {"got": size}
    assert _Handler.seen[-1] == ("PUT", "/put", str(size), None, video.read_bytes())
