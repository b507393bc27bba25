"""Publishing: archive.org and YouTube uploads, email and SMS
notifications and their routing from the event bus (the port of
``framewright_tpu/uploads.py``).

Every sender goes through an injectable ``Transport`` (``cloud.py``'s) or
SMTP factory; callers pass the credentials, nothing reads ambient
secrets. For the same inputs and replies each request is the JAX class's.
JAX's uploaders read the whole video into host memory (a 4K 4:2:0 Y4M is
12.4 MB a frame, about 1 TB an hour at 24 fps); here the archive.org PUT
hands the transport the open file, which ``urllib`` sends in blocks, and
each YouTube chunk of ``CHUNK`` bytes is read at its offset.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import BinaryIO, Dict, List, Optional

from framewright_tpu_torch.cloud import Transport, _as_json, _urllib_transport, urllib_request
from framewright_tpu_torch.errors import FramewrightError
from framewright_tpu_torch.events import EventBus, EventType

logger = logging.getLogger(__name__)


class UploadError(FramewrightError):
    pass


def _header_aware_transport(method: str, url: str, headers: Dict[str, str], body):
    """The urllib transport with the ``Location`` response header folded
    into the JSON body (a resumable session's URL arrives as a header)."""
    import urllib.request

    req = urllib_request(method, url, headers, body)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            raw = resp.read()
            loc = resp.headers.get("Location", "")
            if loc:
                merged = _as_json(raw)
                merged["location"] = loc
                return resp.status, json.dumps(merged).encode()
            return resp.status, raw
    except Exception as exc:  # noqa: BLE001 - any failure of the request
        raise UploadError(f"{method} {url} failed: {exc}") from exc


def _open_video(path: Path) -> BinaryIO:
    """The video, opened for the uploaders' reads."""
    return open(path, "rb")


@dataclass
class UploadResult:
    ok: bool
    url: str = ""
    item_id: str = ""
    error: str = ""

    def __bool__(self) -> bool:
        return self.ok


# -- archive.org (IAS3) ---------------------------------------------------------------------

@dataclass
class ArchiveMetadata:
    """An archive.org item's metadata."""

    identifier: str
    title: str
    description: str = ""
    creator: str = ""
    date: str = ""
    subjects: List[str] = field(default_factory=list)
    collection: str = "opensource_movies"
    mediatype: str = "movies"
    license_url: str = ""

    def validate(self) -> List[str]:
        errors = []
        ident = self.identifier
        if not ident or len(ident) < 3:
            errors.append("identifier must be >= 3 chars")
        if ident and not all(c.isalnum() or c in "-_." for c in ident):
            errors.append("identifier may use only [a-zA-Z0-9-_.]")
        if not self.title:
            errors.append("title required")
        return errors


class ArchiveUploader:
    """archive.org upload through IAS3: a PUT to s3.us.archive.org with LOW
    auth, the body sent from the file."""

    def __init__(self, access_key: str = "", secret_key: str = "",
                 transport: Optional[Transport] = None):
        self.access_key = access_key
        self.secret_key = secret_key
        self._transport = transport or _urllib_transport

    def is_authenticated(self) -> bool:
        return bool(self.access_key and self.secret_key)

    def check_identifier_available(self, identifier: str) -> bool:
        status, body = self._transport("GET", f"https://archive.org/metadata/{identifier}",
                                       {}, None)
        meta = _as_json(body)
        return status != 200 or not meta or not meta.get("metadata")

    def upload(self, video: Path, metadata: ArchiveMetadata) -> UploadResult:
        errors = metadata.validate()
        if errors:
            return UploadResult(False, error="; ".join(errors))
        if not self.is_authenticated():
            return UploadResult(False, error="missing IAS3 keys")
        video = Path(video)
        if not video.exists():
            return UploadResult(False, error=f"no such file: {video}")
        headers = {
            "authorization": f"LOW {self.access_key}:{self.secret_key}",
            "x-archive-auto-make-bucket": "1",
            "x-archive-meta-mediatype": metadata.mediatype,
            "x-archive-meta-collection": metadata.collection,
            "x-archive-meta-title": metadata.title,
            "content-type": "application/octet-stream",
        }
        if metadata.description:
            headers["x-archive-meta-description"] = metadata.description
        if metadata.creator:
            headers["x-archive-meta-creator"] = metadata.creator
        if metadata.date:
            headers["x-archive-meta-date"] = metadata.date
        if metadata.license_url:
            headers["x-archive-meta-licenseurl"] = metadata.license_url
        for i, subj in enumerate(metadata.subjects, 1):
            headers[f"x-archive-meta{i:02d}-subject"] = subj
        url = f"https://s3.us.archive.org/{metadata.identifier}/{video.name}"
        with _open_video(video) as body:
            status, _ = self._transport("PUT", url, headers, body)
        if status not in (200, 201):
            return UploadResult(False, error=f"IAS3 PUT returned {status}")
        return UploadResult(True, url=f"https://archive.org/details/{metadata.identifier}",
                            item_id=metadata.identifier)

    def get_upload_status(self, identifier: str) -> Dict:
        status, body = self._transport("GET", f"https://archive.org/metadata/{identifier}",
                                       {}, None)
        if status != 200:
            return {"exists": False}
        meta = _as_json(body)
        return {"exists": bool(meta.get("metadata")), "files": len(meta.get("files", []))}


# -- YouTube (OAuth2 and the resumable upload protocol) --------------------------------------

@dataclass
class YouTubeMetadata:
    title: str
    description: str = ""
    tags: List[str] = field(default_factory=list)
    category_id: str = "22"
    privacy: str = "private"          # private | unlisted | public

    def validate(self) -> List[str]:
        errors = []
        if not self.title or len(self.title) > 100:
            errors.append("title required, <= 100 chars")
        if self.privacy not in ("private", "unlisted", "public"):
            errors.append("privacy must be private|unlisted|public")
        return errors


class YouTubeUploader:
    """YouTube Data API v3 resumable upload; an OAuth2 access token comes
    from the caller or ``refresh_access_token``. Each chunk of ``CHUNK``
    bytes is read from the file at its offset."""

    UPLOAD_URL = ("https://www.googleapis.com/upload/youtube/v3/videos"
                  "?uploadType=resumable&part=snippet,status")
    TOKEN_URL = "https://oauth2.googleapis.com/token"
    CHUNK = 8 * 1024 * 1024

    def __init__(self, access_token: str = "", transport: Optional[Transport] = None):
        self.access_token = access_token
        self._transport = transport or _header_aware_transport

    def is_authenticated(self) -> bool:
        return bool(self.access_token)

    def refresh_access_token(self, client_id: str, client_secret: str,
                             refresh_token: str) -> bool:
        body = ("&".join(f"{k}={v}" for k, v in {
            "client_id": client_id, "client_secret": client_secret,
            "refresh_token": refresh_token, "grant_type": "refresh_token"}.items())).encode()
        status, resp = self._transport(
            "POST", self.TOKEN_URL, {"content-type": "application/x-www-form-urlencoded"}, body)
        tok = _as_json(resp).get("access_token", "")
        if status == 200 and tok:
            self.access_token = tok
            return True
        return False

    def upload(self, video: Path, metadata: YouTubeMetadata) -> UploadResult:
        errors = metadata.validate()
        if errors:
            return UploadResult(False, error="; ".join(errors))
        if not self.is_authenticated():
            return UploadResult(False, error="missing OAuth2 access token")
        video = Path(video)
        if not video.exists():
            return UploadResult(False, error=f"no such file: {video}")
        snippet = {
            "snippet": {"title": metadata.title, "description": metadata.description,
                        "tags": metadata.tags, "categoryId": metadata.category_id},
            "status": {"privacyStatus": metadata.privacy},
        }
        with _open_video(video) as f:
            size = os.fstat(f.fileno()).st_size
            # 1) open a resumable session
            status, resp = self._transport(
                "POST", self.UPLOAD_URL,
                {"authorization": f"Bearer {self.access_token}",
                 "content-type": "application/json; charset=UTF-8",
                 "x-upload-content-length": str(size),
                 "x-upload-content-type": "video/*"},
                json.dumps(snippet).encode())
            if status != 200:
                return UploadResult(False, error=f"session open returned {status}")
            session = _as_json(resp).get("location", "")
            if not session:
                return UploadResult(False, error="no resumable session URL")
            # 2) the bytes in chunks with Content-Range; 308 asks for the next
            offset = 0
            body = {}
            while offset < size:
                f.seek(offset)
                chunk = f.read(min(self.CHUNK, size - offset))
                end = offset + len(chunk) - 1
                status, resp = self._transport(
                    "PUT", session,
                    {"authorization": f"Bearer {self.access_token}",
                     "content-length": str(len(chunk)),
                     "content-range": f"bytes {offset}-{end}/{size}"},
                    chunk)
                if status in (200, 201):
                    body = _as_json(resp)
                    break
                if status != 308:
                    return UploadResult(False, error=f"chunk PUT returned {status}")
                offset = end + 1
        vid = body.get("id", "")
        return UploadResult(bool(vid), url=f"https://youtu.be/{vid}" if vid else "",
                            item_id=vid, error="" if vid else "no video id in response")


# -- email and SMS notifications ------------------------------------------------------------

@dataclass
class EmailConfig:
    smtp_host: str
    smtp_port: int = 587
    username: str = ""
    password: str = ""
    sender: str = ""
    recipients: List[str] = field(default_factory=list)
    use_tls: bool = True


class EmailSender:
    """SMTP sender: STARTTLS when ``use_tls``, a login when a user name is
    given. ``smtp_factory(host, port)`` is injectable."""

    def __init__(self, config: EmailConfig, smtp_factory=None):
        self.config = config
        self._smtp_factory = smtp_factory or self._default_factory

    @staticmethod
    def _default_factory(host: str, port: int):
        import smtplib

        return smtplib.SMTP(host, port, timeout=15)

    def send(self, subject: str, body: str) -> bool:
        cfg = self.config
        if not cfg.recipients:
            return False
        from email.mime.text import MIMEText

        msg = MIMEText(body)
        msg["Subject"] = subject
        msg["From"] = cfg.sender or cfg.username
        msg["To"] = ", ".join(cfg.recipients)
        try:
            smtp = self._smtp_factory(cfg.smtp_host, cfg.smtp_port)
            try:
                if cfg.use_tls:
                    smtp.starttls()
                if cfg.username:
                    smtp.login(cfg.username, cfg.password)
                smtp.sendmail(msg["From"], cfg.recipients, msg.as_string())
            finally:
                smtp.quit()
            return True
        except Exception as exc:  # noqa: BLE001 - a notification is best effort
            logger.warning("email notify failed: %s", exc)
            return False


class SMSSender:
    """SMS through an HTTP gateway: ``POST {"to", "body"}`` (the body cut
    to 160 characters), a bearer token when ``api_key`` is given; a 2xx
    answer is a send."""

    def __init__(self, gateway_url: str, api_key: str = "",
                 transport: Optional[Transport] = None):
        self.gateway_url = gateway_url
        self.api_key = api_key
        self._transport = transport or _urllib_transport

    def send(self, to: str, body: str) -> bool:
        headers = {"content-type": "application/json"}
        if self.api_key:
            headers["authorization"] = f"Bearer {self.api_key}"
        try:
            status, _ = self._transport("POST", self.gateway_url, headers,
                                        json.dumps({"to": to, "body": body[:160]}).encode())
            return 200 <= status < 300
        except Exception as exc:  # noqa: BLE001
            logger.warning("sms notify failed: %s", exc)
            return False


class NotificationRouter:
    """Job completions and failures on an ``EventBus`` sent by email and
    SMS; ``sent`` names each send that went out."""

    EVENTS = (EventType.JOB_COMPLETED, EventType.JOB_FAILED)

    def __init__(self, email: Optional[EmailSender] = None,
                 sms_sender: Optional[SMSSender] = None, sms_to: str = ""):
        self.email = email
        self.sms_sender = sms_sender
        self.sms_to = sms_to
        self.sent: List[str] = []

    def attach(self, bus: EventBus) -> None:
        for ev in self.EVENTS:
            bus.subscribe(self._handle, ev)

    def _handle(self, event) -> None:
        name = event.type.value
        summary = json.dumps(event.data, default=str)[:400]
        subject = f"[framewright] {name}"
        if self.email is not None and self.email.send(subject, summary):
            self.sent.append(f"email:{name}")
        if self.sms_sender is not None and self.sms_to and \
                self.sms_sender.send(self.sms_to, f"{subject}: {summary}"):
            self.sent.append(f"sms:{name}")
