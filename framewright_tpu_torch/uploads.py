"""Notifications that the ``notify`` verb sends (the part of
``framewright_tpu.uploads`` the port keeps): email over SMTP and SMS
through an HTTP gateway that takes ``POST {to, body}``. Callers pass the
server, the credentials and the recipients; nothing reads ambient
secrets. A send reports failure as ``False`` and logs why. The uploaders
(``ArchiveUploader``, ``YouTubeUploader``) and the ``upload`` verb are not
ported: they exist to reach outside services (ROADMAP "Not queued")."""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

# (method, url, headers, body) -> (status, response body)
Transport = Callable[[str, str, Dict[str, str], Optional[bytes]], Tuple[int, bytes]]


def _urllib_transport(method: str, url: str, headers: Dict[str, str],
                      body: Optional[bytes]) -> Tuple[int, bytes]:
    import urllib.request

    req = urllib.request.Request(url, data=body, headers=headers, method=method)
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, resp.read()


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
