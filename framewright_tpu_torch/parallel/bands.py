"""Row bands of a frame over a mesh's ``space`` axis: the SR's frames x
space split (JAX ``SRConfig(sharding="2d")``, ``framewright_tpu/
processors/super_resolution.py:194-217``).

JAX shards the frame's height over ``space`` and XLA exchanges each
convolution's halo rows between the shards. The port's kernels read
their whole input from device memory and pad zeros at its edges, so a
band holds its own rows plus ``halo`` rows of each neighbour (none past
the frame's edges, where the zeros are the frame's own SAME padding).
Each kernel's result at a pixel depends only on the pixels its stencil
reads (ROADMAP B's three semantics), so after a stage that reads up to
``halo`` rows around a pixel the band's own rows equal the whole frame's,
and only its halo rows hold values computed from the zeros at its edges.
``exchange`` then copies each halo row from the band that owns that row,
and every row of every band is again the whole frame's. ``with_rows``
hands a band that holds no halo its neighbours' rows for one stage
(TVSR's shifted windows, cyclic as their roll is); both count the bytes
they copy in ``exchange.bytes``. ``gather`` stacks the bands' own rows of
an output whose rows are ``scale`` times the layout's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from framewright_tpu_torch.errors import ShardingError


@dataclass(frozen=True)
class Bands:
    height: int                          # the frame's rows at the layout's resolution
    halo: int                            # neighbour rows a band holds on each side
    cuts: Tuple[Tuple[int, int], ...]    # each band's own rows [a, b) of the frame
    devices: Tuple[torch.device, ...]    # each band's device

    @classmethod
    def split(cls, height: int, devices: Sequence[torch.device], halo: int,
              align: int = 1) -> "Bands":
        """``height`` rows in len(devices) bands as equal as cuts at
        multiples of ``align`` allow (the first bands the longer)."""
        n = len(devices)
        units = -(-height // align)
        if units < n:
            raise ShardingError(f"{height} rows cannot make {n} bands of {align}-row units")
        base, extra = divmod(units, n)
        cuts, start = [], 0
        for i in range(n):
            end = min(height, start + (base + (i < extra)) * align)
            cuts.append((start, end))
            start = end
        return cls(height, halo, tuple(cuts), tuple(torch.device(d) for d in devices))

    def __len__(self) -> int:
        return len(self.cuts)

    def span(self, i: int) -> Tuple[int, int]:
        """The frame rows band i holds: its own and the halo."""
        a, b = self.cuts[i]
        return max(0, a - self.halo), min(self.height, b + self.halo)

    def own(self, i: int) -> Tuple[int, int]:
        """Band i's own rows in its tensor's coordinates."""
        lo = self.span(i)[0]
        a, b = self.cuts[i]
        return a - lo, b - lo

    @property
    def rows(self) -> int:
        """The rows of the tallest band (its own and its halo)."""
        return max(hi - lo for lo, hi in map(self.span, range(len(self))))

    def cut(self, x: torch.Tensor, scale: int = 1) -> List[torch.Tensor]:
        """Each band of ``x`` (B, height * scale, ...): its rows, contiguous,
        on its device."""
        return [x[:, lo * scale:hi * scale].to(d).contiguous()
                for (lo, hi), d in zip(map(self.span, range(len(self))), self.devices)]

    def exchange(self, bands: Sequence[torch.Tensor], channels: Optional[int] = None) -> int:
        """Copy every halo row of every band (channels ``:channels`` of
        the last axis, or all) from the band that owns that row; -> the
        bytes copied, also added to ``exchange.bytes``."""
        moved = 0
        for i, dst in enumerate(bands):
            lo_i, hi_i = self.span(i)
            for j, src in enumerate(bands):
                if i == j:
                    continue
                a, b = self.cuts[j]
                r0, r1 = max(lo_i, a), min(hi_i, b)
                if r0 >= r1:
                    continue
                lo_j = self.span(j)[0]
                d = dst[:, r0 - lo_i:r1 - lo_i]
                s = src[:, r0 - lo_j:r1 - lo_j]
                if channels is not None:
                    d, s = d[..., :channels], s[..., :channels]
                d.copy_(s, non_blocking=True)
                moved += s.numel() * s.element_size()
        Bands.exchange.bytes += moved
        return moved

    exchange.bytes = 0

    def with_rows(self, parts: Sequence[torch.Tensor], i: int, n: int, axis: int = 1,
                  cyclic: bool = False) -> torch.Tensor:
        """Band i's own rows (``parts[i]``, rows on ``axis``, no halo held)
        with n rows of each neighbour band around them, copied to band i's
        device: across the frame's ends too when ``cyclic`` (the last
        band's rows above the first band's), else none past them (one
        band: ``parts[0]`` as it is). The bytes copied are added to
        ``exchange.bytes``."""
        k, d = len(parts), parts[i].device
        rows = [parts[i]]
        if i > 0 or cyclic:
            rows.insert(0, parts[(i - 1) % k].narrow(axis, parts[(i - 1) % k].shape[axis] - n, n))
        if i < k - 1 or cyclic:
            rows.append(parts[(i + 1) % k].narrow(axis, 0, n))
        if len(rows) == 1:
            return parts[i]
        Bands.exchange.bytes += sum(r.numel() * r.element_size() for r in rows if r is not parts[i])
        return torch.cat([r.to(d) for r in rows], dim=axis)

    def gather(self, outs: Sequence[torch.Tensor], scale: int,
               device: torch.device) -> torch.Tensor:
        """The frame from each band's output (B, rows * scale, ...): their
        own rows, in order, on ``device`` (one band's output as it is);
        the bytes of the parts of several bands are added to
        ``gather.bytes``."""
        if len(outs) == 1:
            a, b = self.own(0)
            return outs[0][:, a * scale:b * scale].to(device)
        parts = []
        for i, y in enumerate(outs):
            a, b = self.own(i)
            parts.append(y[:, a * scale:b * scale].to(device))
        Bands.gather.bytes += sum(p.numel() * p.element_size() for p in parts)
        return torch.cat(parts, dim=1)

    gather.bytes = 0
