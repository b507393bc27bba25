"""SRVGGNetCompact (realesr-animevideov3, realesr-general-x4v3 and the
repository's FW_fastvgg models) as a torch ``nn.Module``.

The port of ``framewright_tpu/models/srvgg.py`` and of the forward in
``framewright_tpu/ops/fused_srvgg.py``. Public functions keep the JAX
package's layout: NHWC input in [0, 1]; output (B, sH, sW, 3) float32,
or uint8 planes Y (B, sH, sW), U and V (B, sH/2, sW/2).

  apply       plain PyTorch forward (counterpart of ``srvgg.apply``),
              computed in the input's dtype like the JAX conv2d
  apply_fast  the kernel path (counterpart of ``fused_srvgg.apply_fast``):
              conv0 and PReLU in F.conv2d, the 64->64 chain through the
              chain kernels in groups of GROUP convs (bf16 or int8 after
              the weights), conv_last in f32 on the bf16 features,
              pixel_shuffle, the nearest-upsampled input, then the
              uint8/YUV epilogue (``layers.out_epilogue``)
  calibrate_act_scales  the int8 activation ranges from one bf16 pass
              (counterpart of ``fused_srvgg.calibrate_act_scales``)

Parameter names follow the official SRVGGNetCompact state dict: convs at
``body.{2i}``, PReLU alphas at ``body.{2i+1}.weight``, the last conv at
``body.{2 num_conv + 2}``, so a basicsr ``.pth`` loads with no renaming.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn

from framewright_tpu_torch.models.layers import (
    conv2d,
    jax_conv_init,
    out_epilogue,
    pixel_shuffle,
    prelu,
    upsample_nearest,
)


@dataclass(frozen=True)
class SRVGGConfig:
    num_in_ch: int = 3
    num_out_ch: int = 3
    num_feat: int = 64
    num_conv: int = 32          # 16 for animevideov3, 32 for general-x4v3
    scale: int = 4
    act_type: str = "prelu"


def jax_init(cfg: SRVGGConfig, seed: int = 0) -> Dict:
    """JAX's ``srvgg.init(PRNGKey(seed), cfg)``: the same tree and draws."""
    from framewright_tpu_torch.ops import jax_random

    keys = iter(jax_random.split(seed, cfg.num_conv + 4))
    nf = cfg.num_feat
    body = [jax_conv_init(next(keys), 3, cfg.num_in_ch, nf)]
    body += [jax_conv_init(next(keys), 3, nf, nf) for _ in range(cfg.num_conv)]
    last = jax_conv_init(next(keys), 3, nf, cfg.num_out_ch * cfg.scale ** 2)
    acts = [{"alpha": np.full((nf,), 0.25, np.float32)} for _ in range(cfg.num_conv + 1)]
    return {"body": body, "act": acts, "conv_last": last}


@dataclass
class FastWeights:
    """The chain kernels' weights: a list of ``fused_srvgg.ChainGroup``
    (bf16) or ``ChainGroupInt8`` (int8)."""
    groups: list


class SRVGGNet(nn.Module):
    def __init__(self, cfg: SRVGGConfig = SRVGGConfig()):
        super().__init__()
        if cfg.act_type != "prelu":
            raise ValueError(f"SRVGGNet: act_type {cfg.act_type!r} is not ported "
                             "(every registered model uses prelu)")
        self.cfg = cfg
        nf = cfg.num_feat
        body: List[nn.Module] = [nn.Conv2d(cfg.num_in_ch, nf, 3, padding=1),
                                 nn.PReLU(nf)]
        for _ in range(cfg.num_conv):
            body += [nn.Conv2d(nf, nf, 3, padding=1), nn.PReLU(nf)]
        body.append(nn.Conv2d(nf, cfg.num_out_ch * cfg.scale ** 2, 3, padding=1))
        self.body = nn.ModuleList(body)
        self._fast: Optional[FastWeights] = None
        self._fast_int8: Optional[FastWeights] = None

    @classmethod
    def from_state_dict(cls, cfg: SRVGGConfig, sd: Dict[str, torch.Tensor],
                        device: torch.device) -> "SRVGGNet":
        """Build on the meta device (no throwaway init), then take the
        state dict's tensors as parameters and move them to ``device``."""
        with torch.device("meta"):
            model = cls(cfg)
        model.load_state_dict(sd, assign=True)
        return model.to(device).eval().requires_grad_(False)

    @property
    def convs(self) -> List[nn.Conv2d]:
        """conv0, the num_conv chain convs, conv_last."""
        return list(self.body[0::2])

    @property
    def acts(self) -> List[nn.PReLU]:
        """The PReLU after conv0 and after each chain conv."""
        return list(self.body[1::2])

    # -- plain path ------------------------------------------------------
    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Plain forward. x: (B, H, W, C) in [0, 1], computed in x's dtype.
        Named after ``srvgg.apply``, it shadows ``nn.Module.apply(fn)``,
        which the port never calls."""
        feat = x
        for conv, act in zip(self.convs, self.acts):
            feat = prelu(conv2d(feat, conv.weight, conv.bias), act.weight)
        last = self.convs[-1]
        out = pixel_shuffle(conv2d(feat, last.weight, last.bias), self.cfg.scale)
        return out + upsample_nearest(x, self.cfg.scale)

    # -- kernel path -----------------------------------------------------
    def fast_weights(self) -> FastWeights:
        """The bf16 chain's weights (``make_fast_params``), built on first
        use on the module's device."""
        if self._fast is None:
            from framewright_tpu_torch.ops import fused_srvgg

            self._fast = FastWeights(fused_srvgg.chain_weights(
                self.convs[1:-1], self.acts[1:]))
        return self._fast

    def fast_weights_int8(self, act_amax) -> FastWeights:
        """Build and hold the int8 chain's weights
        (``make_fast_params_int8``) from the (num_conv + 1,) activation
        ranges of ``calibrate_act_scales``; ``apply_fast`` then runs the
        int8 chain."""
        from framewright_tpu_torch.ops import fused_srvgg

        self._fast_int8 = FastWeights(fused_srvgg.chain_weights_int8(
            self.convs[1:-1], self.acts[1:], act_amax))
        return self._fast_int8

    @property
    def int8_weights(self) -> Optional[FastWeights]:
        """The int8 fast weights the model holds, or None."""
        return self._fast_int8

    def apply_fast(self, x: torch.Tensor, out_mode: str = "f32",
                   full_range: bool = False, weights: Optional[FastWeights] = None):
        """Kernel forward (``fused_srvgg._apply_fast_impl``). x: (B, H, W, 3)
        in [0, 1]; conv0 and its PReLU run in x's dtype (bf16 on the
        restore path), the chain in bf16 or int8 after ``weights`` (default:
        the int8 weights when the model holds them, else the bf16 ones),
        conv_last in f32 on the bf16 features. Output per ``out_mode``: the
        f32 RGB image ("f32"), rgb_u8, or the yuv420_u8 planes."""
        from framewright_tpu_torch.ops import fused_srvgg

        fw = weights or self._fast_int8 or self.fast_weights()
        out = self.tail(fused_srvgg.conv_chain(self.head(x), fw.groups), x)
        if out_mode == "f32":
            return out
        return out_epilogue(out, out_mode, full_range)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """conv0 and its PReLU in x's dtype -> the chain's contiguous bf16
        input (B, H, W, 64)."""
        conv0 = self.convs[0]
        feat = prelu(conv2d(x, conv0.weight, conv0.bias), self.acts[0].weight)
        return feat.to(torch.bfloat16).contiguous()

    def tail(self, feat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """conv_last in f32 on the chain's bf16 output (its operands are
        bf16 values, exact in TF32 as in f32), pixel_shuffle, plus the
        nearest-upsampled input (added in place: f32 + bf16 is exact)."""
        last = self.convs[-1]
        out = conv2d(feat.float(), last.weight, last.bias)
        del feat
        out = pixel_shuffle(out, self.cfg.scale)
        out += upsample_nearest(x, self.cfg.scale)
        return out


def calibrate_act_scales(model: SRVGGNet, sample: torch.Tensor,
                         margin: float = 1.25) -> np.ndarray:
    """Activation ranges for the int8 chain (counterpart of
    ``fused_srvgg.calibrate_act_scales``): the model's forward in bf16 on
    ``sample`` (B, H, W, 3) in [0, 1], with bf16 PReLU products, recording
    max|.| after conv0's PReLU and after each chain conv's, times
    ``margin``. -> (num_conv + 1,) float32 numpy. Counted in
    ``calibrate_act_scales.calls``."""
    calibrate_act_scales.calls += 1
    dev = model.convs[0].weight.device
    with torch.no_grad():
        feat = sample.to(dev).to(torch.bfloat16)
        stats = []
        for conv, act in zip(model.convs[:-1], model.acts):
            feat = prelu(conv2d(feat, conv.weight, conv.bias), act.weight)
            stats.append(feat.abs().amax())
        amax = torch.stack(stats).float() * margin
    return amax.cpu().numpy()


calibrate_act_scales.calls = 0
