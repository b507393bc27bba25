"""YUV4MPEG2 (.y4m) reader and writer: the port's own copy of
``framewright_tpu.io.y4m``. 4:2:0 at even sizes is converted by the
port's native host codec (``framewright_tpu_torch.native``, its copy of
the JAX package's ``native/fwcore.cpp``), as the JAX reader and writer
call theirs; ``yuv_to_rgb`` and ``rgb_to_yuv420`` here are the same
integer arithmetic in numpy, which runs where the library cannot be
built. Other subsamplings decode with the float math of
``framewright_tpu.io.color``, as the JAX reader does. ``codec`` on a
reader or writer says which conversion its frames take.

Format: ASCII stream header ``YUV4MPEG2 W<w> H<h> F<num>:<den> ...``
followed by frames, each ``FRAME[params]\\n`` + raw planar YUV.
Colourspaces: C420 (jpeg/mpeg2/paldv sized alike), C422, C444, Cmono.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from fractions import Fraction
from pathlib import Path
from typing import BinaryIO, Iterable, Iterator, Optional, Union

import numpy as np

from framewright_tpu_torch import native
from framewright_tpu_torch.errors import MediaFormatError

_MAGIC = b"YUV4MPEG2"


def _plane_shapes(cs: str, w: int, h: int):
    base = cs.split()[0]
    if base.startswith("420"):
        return (h, w), (h // 2, w // 2), (h // 2, w // 2)
    if base.startswith("422"):
        return (h, w), (h, w // 2), (h, w // 2)
    if base.startswith("444"):
        return (h, w), (h, w), (h, w)
    if base.startswith("mono"):
        return (h, w), None, None
    raise MediaFormatError(f"Unsupported Y4M colorspace C{cs}")


def _upsample_chroma(u: np.ndarray, h: int, w: int) -> np.ndarray:
    if u.shape == (h, w):
        return u
    ry, rx = h // u.shape[0], w // u.shape[1]
    return np.repeat(np.repeat(u, ry, axis=0), rx, axis=1)[:h, :w]


def _yuv_to_rgb_float(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                      full_range: bool) -> np.ndarray:
    """BT.601 in float32 numpy (``framewright_tpu.io.color.yuv420_to_rgb``):
    the JAX reader's decode of chroma that is not 4:2:0 at even sizes."""
    h, w = y.shape
    yf = y.astype(np.float32)
    uf = _upsample_chroma(u, h, w).astype(np.float32) - 128.0
    vf = _upsample_chroma(v, h, w).astype(np.float32) - 128.0
    if not full_range:
        yf = (yf - 16.0) * (255.0 / 219.0)
        uf = uf * (255.0 / 224.0)
        vf = vf * (255.0 / 224.0)
    r = yf + 1.402 * vf
    g = yf - 0.344136 * uf - 0.714136 * vf
    b = yf + 1.772 * uf
    return np.clip(np.stack([r, g, b], axis=-1) + 0.5, 0, 255).astype(np.uint8)


def _clamp_u8(v: np.ndarray) -> np.ndarray:
    return np.clip(v, 0, 255).astype(np.uint8)


def _is_420(y: np.ndarray, u: np.ndarray) -> bool:
    h, w = y.shape
    return h % 2 == 0 and w % 2 == 0 and u.shape == (h // 2, w // 2)


def yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray,
               full_range: bool = False) -> np.ndarray:
    """Planar YUV uint8 -> RGB uint8 (H, W, 3), BT.601, as the JAX reader
    decodes it. 4:2:0 at even sizes: the 16.16 fixed-point arithmetic of
    the JAX package's native decoder (``native/fwcore.cpp``,
    ``yuv420_to_rgb``) in int32 numpy, ``>>`` a floor shift as there;
    any other subsampling: the float math it falls back to."""
    if not _is_420(y, u):
        return _yuv_to_rgb_float(y, u, v, full_range)
    h, w = y.shape
    yi = y.astype(np.int32)
    ui = _upsample_chroma(u, h, w).astype(np.int32) - 128
    vi = _upsample_chroma(v, h, w).astype(np.int32) - 128
    if full_range:
        yf = yi << 16
    else:
        yf = (yi - 16) * 76309            # (Y - 16) * 255/219
        ui = (ui * 74313) >> 16           # * 255/224
        vi = (vi * 74313) >> 16
    r = (yf + 91881 * vi + 32768) >> 16                   # 1.402
    g = (yf - 22554 * ui - 46802 * vi + 32768) >> 16      # 0.344136, 0.714136
    b = (yf + 116130 * ui + 32768) >> 16                  # 1.772
    return _clamp_u8(np.stack([r, g, b], axis=-1))


def rgb_to_yuv420(rgb: np.ndarray, full_range: bool = False):
    """RGB uint8 (H, W, 3), H and W even -> planar YUV420 uint8, BT.601:
    the 16.16 fixed-point arithmetic of the JAX package's native encoder
    (``native/fwcore.cpp``, ``rgb_to_yuv420``), chroma from the 2x2
    integer box mean ``s / 4``."""
    h, w = rgb.shape[:2]
    r, g, b = (rgb[..., i].astype(np.int32) for i in range(3))
    y = (19595 * r + 38470 * g + 7471 * b + 32768) >> 16   # 0.299, 0.587, 0.114
    if not full_range:
        y = ((y * 56283 + 32768) >> 16) + 16               # * 219/255

    def box(c: np.ndarray) -> np.ndarray:
        return c.reshape(h // 2, 2, w // 2, 2).sum(axis=(1, 3)) // 4

    rm, gm, bm = box(r), box(g), box(b)
    ym = (19595 * rm + 38470 * gm + 7471 * bm) >> 16
    u = ((bm - ym) * 36984) >> 16                           # / 1.772
    v = ((rm - ym) * 46727) >> 16                           # / 1.402
    if not full_range:
        u = (u * 57475) >> 16                               # * 224/255
        v = (v * 57475) >> 16
    return _clamp_u8(y), _clamp_u8(u + 128), _clamp_u8(v + 128)


@dataclass
class Y4MHeader:
    width: int
    height: int
    fps: Fraction
    interlace: str = "p"
    aspect: str = "1:1"
    colorspace: str = "420jpeg"

    def to_line(self) -> bytes:
        return (f"{_MAGIC.decode()} W{self.width} H{self.height} "
                f"F{self.fps.numerator}:{self.fps.denominator} "
                f"I{self.interlace} A{self.aspect} C{self.colorspace}\n").encode()

    @classmethod
    def parse(cls, line: bytes) -> "Y4MHeader":
        toks = line.decode("ascii", "replace").strip().split()
        if not toks or toks[0] != _MAGIC.decode():
            raise MediaFormatError("Not a YUV4MPEG2 stream")
        kw: dict = {"width": 0, "height": 0, "fps": Fraction(25, 1)}
        for tok in toks[1:]:
            tag, val = tok[0], tok[1:]
            if tag == "W":
                kw["width"] = int(val)
            elif tag == "H":
                kw["height"] = int(val)
            elif tag == "F":
                num, den = val.split(":")
                kw["fps"] = Fraction(int(num), int(den))
            elif tag == "I":
                kw["interlace"] = val
            elif tag == "A":
                kw["aspect"] = val
            elif tag == "C":
                kw["colorspace"] = val
        if kw["width"] <= 0 or kw["height"] <= 0:
            raise MediaFormatError("Y4M header missing W/H")
        return cls(**kw)


class Y4MReader:
    """Sequential frame reader yielding RGB uint8 (H, W, 3) arrays."""

    def __init__(self, src: Union[str, Path, BinaryIO],
                 full_range: Optional[bool] = None):
        if hasattr(src, "read"):
            self._f: BinaryIO = src  # type: ignore[assignment]
            self._owns = False
        else:
            self._f = open(src, "rb")
            self._owns = True
        try:
            self.header = Y4MHeader.parse(self._f.readline(256))
            self._shapes = _plane_shapes(self.header.colorspace,
                                         self.header.width, self.header.height)
        except Exception:
            self.close()
            raise
        # jpeg-suffixed 420 is full range by convention; others limited
        if full_range is None:
            full_range = "jpeg" in self.header.colorspace
        self.full_range = full_range
        self._frame_bytes = sum(s[0] * s[1] for s in self._shapes if s)
        self.frames_read = 0
        ys, us, _ = self._shapes
        even_420 = us is not None and ys[0] % 2 == 0 and ys[1] % 2 == 0 \
            and us == (ys[0] // 2, ys[1] // 2)
        self.codec = "native" if even_420 and native.codec() == "native" else "numpy"

    @property
    def width(self) -> int:
        return self.header.width

    @property
    def height(self) -> int:
        return self.header.height

    @property
    def fps(self) -> float:
        return float(self.header.fps)

    def read_frame(self) -> Optional[np.ndarray]:
        line = self._f.readline(256)
        if not line:
            return None
        if not line.startswith(b"FRAME"):
            raise MediaFormatError(f"Expected FRAME marker, got {line[:20]!r}")
        raw = self._f.read(self._frame_bytes)
        if len(raw) != self._frame_bytes:
            raise MediaFormatError("Truncated Y4M frame")
        ys, us, vs = self._shapes
        off = ys[0] * ys[1]
        y = np.frombuffer(raw, np.uint8, count=off).reshape(ys)
        if us is None:
            rgb = np.repeat(y[..., None], 3, axis=-1)
        else:
            ulen = us[0] * us[1]
            u = np.frombuffer(raw, np.uint8, count=ulen, offset=off).reshape(us)
            v = np.frombuffer(raw, np.uint8, count=ulen,
                              offset=off + ulen).reshape(vs)
            rgb = (native.yuv420_to_rgb(y, u, v, full_range=self.full_range)
                   if self.codec == "native" else
                   yuv_to_rgb(y, u, v, full_range=self.full_range))
        self.frames_read += 1
        return rgb

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            frame = self.read_frame()
            if frame is None:
                return
            yield frame

    def _whole_frames(self, limit: Optional[int] = None):
        """Scan the frames from the current position without decoding
        (seekable streams only) -> (whole frames, the byte offset just
        past the last of them). A frame cut short (a run killed mid-write)
        ends the scan and is not counted: the JAX reader's
        ``count_frames`` seeks past one and counts it whole. Stops after
        ``limit`` frames when given. The position is restored."""
        pos = self._f.tell()
        size = self._f.seek(0, os.SEEK_END)
        self._f.seek(pos)
        n, end = 0, pos
        while limit is None or n < limit:
            line = self._f.readline(256)
            if not line.endswith(b"\n"):
                break
            if not line.startswith(b"FRAME"):
                raise MediaFormatError("Corrupt Y4M stream while counting")
            nxt = self._f.tell() + self._frame_bytes
            if nxt > size:
                break
            self._f.seek(nxt)
            n, end = n + 1, nxt
        self._f.seek(pos)
        return n, end

    def count_frames(self) -> int:
        """Whole frames from the current position, without decoding
        (seekable streams only); a frame cut short is not counted."""
        return self._whole_frames()[0]

    def close(self) -> None:
        if self._owns:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Y4MWriter:
    """Sequential frame writer taking RGB uint8 (H, W, 3) arrays, or
    finished YUV420 planes through ``write_yuv_frame``.

    ``append=True`` continues an existing file (checkpoint resume): its
    header must give ``width`` x ``height``, and its colourspace and range
    are kept (``colorspace``, ``full_range`` and ``fps`` are then
    ignored). The file is cut after its last whole frame, or after
    ``keep_frames`` whole frames when that is fewer, so no partial frame
    stays between the old frames and the new ones; ``frames_written``
    starts at the frames kept. A missing or empty file is written anew."""

    def __init__(self, dst: Union[str, Path, BinaryIO], width: int, height: int,
                 fps: Union[float, Fraction] = 25, colorspace: str = "420jpeg",
                 full_range: Optional[bool] = None, append: bool = False,
                 keep_frames: Optional[int] = None):
        if (width % 2 or height % 2) and colorspace.startswith("420"):
            raise MediaFormatError("4:2:0 requires even dimensions")
        self.frames_written = 0
        if hasattr(dst, "write"):
            self._f: BinaryIO = dst  # type: ignore[assignment]
            self._owns = False
        else:
            dst = Path(dst)
            dst.parent.mkdir(parents=True, exist_ok=True)
            if append and dst.is_file() and dst.stat().st_size > 0:
                self._open_append(dst, width, height, keep_frames)
                return
            self._f = open(dst, "wb")
            self._owns = True
        fps = Fraction(fps).limit_denominator(65536)
        self.header = Y4MHeader(width, height, fps, colorspace=colorspace)
        if full_range is None:
            full_range = "jpeg" in colorspace
        self.full_range = full_range
        self._f.write(self.header.to_line())
        self._set_codec()

    def _set_codec(self) -> None:
        self.codec = ("native" if self.header.colorspace.startswith("420")
                      and native.codec() == "native" else "numpy")

    def _open_append(self, dst: Path, width: int, height: int,
                     keep_frames: Optional[int]) -> None:
        with Y4MReader(dst) as existing:
            if (existing.width, existing.height) != (width, height):
                raise MediaFormatError(
                    f"resume dims mismatch: existing {existing.width}x"
                    f"{existing.height} vs {width}x{height}")
            self.header = existing.header
            self.full_range = existing.full_range
            self.frames_written, end = existing._whole_frames(keep_frames)
        self._f = open(dst, "r+b")
        self._owns = True
        self._f.truncate(end)
        self._f.seek(end)
        self._set_codec()

    def write_frame(self, rgb: np.ndarray) -> None:
        h, w = self.header.height, self.header.width
        if rgb.shape[:2] != (h, w):
            raise MediaFormatError(
                f"Frame shape {rgb.shape[:2]} != writer dims {(h, w)}")
        self._f.write(b"FRAME\n")
        cs = self.header.colorspace
        if cs.startswith("mono"):
            y = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
            self._f.write(np.clip(y + 0.5, 0, 255).astype(np.uint8).tobytes())
        elif cs.startswith("444"):
            yf = rgb.astype(np.float32)
            y = 0.299 * yf[..., 0] + 0.587 * yf[..., 1] + 0.114 * yf[..., 2]
            u = (yf[..., 2] - y) / 1.772 + 128.0
            v = (yf[..., 0] - y) / 1.402 + 128.0
            for p in (y, u, v):
                self._f.write(np.clip(p + 0.5, 0, 255).astype(np.uint8).tobytes())
        else:
            convert = native.rgb_to_yuv420 if self.codec == "native" else rgb_to_yuv420
            for p in convert(rgb, full_range=self.full_range):
                self._f.write(p.tobytes())
        self.frames_written += 1

    def write_yuv_frame(self, y: np.ndarray, u: np.ndarray,
                        v: np.ndarray) -> None:
        """Write planar YUV420 that the SR tail produced on the device."""
        h, w = self.header.height, self.header.width
        if not self.header.colorspace.startswith("420"):
            raise MediaFormatError(
                f"write_yuv_frame needs a 420 colorspace, have "
                f"{self.header.colorspace}")
        if y.shape != (h, w) or u.shape != (h // 2, w // 2) \
                or v.shape != (h // 2, w // 2):
            raise MediaFormatError(
                f"YUV plane shapes {y.shape}/{u.shape}/{v.shape} do not "
                f"match {w}x{h} 4:2:0")
        self._f.write(b"FRAME\n")
        for p in (y, u, v):
            self._f.write(np.ascontiguousarray(p, np.uint8).tobytes())
        self.frames_written += 1

    def close(self) -> None:
        self._f.flush()
        if self._owns:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()



def _raw_frames(r: "Y4MReader", name) -> Iterator[bytes]:
    """Each frame's bytes, undecoded, from the reader's position."""
    while True:
        line = r._f.readline(256)
        if not line:
            return
        if not line.startswith(b"FRAME"):
            raise MediaFormatError(f"Expected FRAME marker, got {line[:20]!r}")
        raw = r._f.read(r._frame_bytes)
        if len(raw) != r._frame_bytes:
            raise MediaFormatError(f"{name}: truncated Y4M frame")
        yield raw


def concat_y4m(parts: Iterable[Union[str, Path]], dst: Union[str, Path],
               fps: Optional[Union[float, Fraction]] = None, start: int = 0,
               end: Optional[int] = None) -> int:
    """Frames ``start`` .. ``end`` - 1 of the parts, taken in order as one
    stream, written into ``dst`` byte for byte under the first part's
    header (its rate replaced by ``fps`` when given); returns the frames
    written. Every part must have the first one's size and colourspace.
    Decoding a 4:2:0 frame to RGB and encoding it again would change its
    chroma; this copies the planes."""
    n = i = 0
    first = None
    with open(dst, "wb") as out:
        for part in parts:
            with Y4MReader(part) as r:
                h = r.header
                if first is None:
                    first = h if fps is None else dataclasses.replace(
                        h, fps=Fraction(fps).limit_denominator(65536))
                    out.write(first.to_line())
                elif (h.width, h.height, h.colorspace) != (first.width, first.height,
                                                          first.colorspace):
                    raise MediaFormatError(f"{part}: {h.width}x{h.height} {h.colorspace}, "
                                           f"the first part {first.width}x{first.height} "
                                           f"{first.colorspace}")
                for raw in _raw_frames(r, part):
                    if end is not None and i >= end:
                        return n
                    if i >= start:
                        out.write(b"FRAME\n")
                        out.write(raw)
                        n += 1
                    i += 1
    return n
