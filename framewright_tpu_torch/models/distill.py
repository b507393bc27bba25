"""On-device SR training: the port of ``framewright_tpu/models/distill.py``.

The repository's own checkpoints are trained here: the 6-block RRDB
student ``FW_fast6_x2`` and the SRVGG student ``FW_fastvgg_x2``
(``train_student``: supervised on synthetic degradations, or distilled
from an RRDB teacher), the diffusion SR (``train_diffusion``, then
``finetune_sampler`` through the DDIM sampler) and the NAFNet denoiser
``FW_nafnet_dn`` (``train_denoiser``). The data is the JAX package's
numpy synthesis, copied (``synth_hr_patch``, ``degrade``, ...), so the
same seed gives the same batches bit for bit.

JAX trains with ``jax.value_and_grad`` over its plain XLA forwards and
``optax.adam(cosine_decay_schedule(lr, steps, alpha=0.1))``; here the
port's plain forwards under autograd and ``Adam``, the same update. A
trainer starts from ``jax_init`` of its family (JAX's draws) unless
``params`` warm-starts it, and returns f32 numpy trees in the layout it
was given (from scratch the RRDB body stacked, as JAX's ``stack_body``).
Every forward and ``backward()`` runs in full f32 (``hw.full_f32``: JAX's
f32 convolutions run at ``HIGHEST``) and under ``hw.deterministic`` (the
same bytes every run). ``report``, a dict when given, receives each
step's loss and the ops that warned they have no deterministic CUDA
implementation. Trainers run on the card unless ``device="cpu"``.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from framewright_tpu_torch.hw import deterministic, full_f32, resolve_device

# ---------------------------------------------------------------------------
# Synthetic image-like HR patches and the degradation model (JAX's, copied)
# ---------------------------------------------------------------------------


def synth_hr_patch(rng: np.random.Generator, size: int) -> np.ndarray:
    """(size, size, 3) float32 in [0, 1]: gradients, shapes, texture and
    high-contrast strokes."""
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    a, b, c = rng.uniform(-1, 1, 3)
    img = 0.5 + 0.25 * (a * xx + b * yy) / size + 0.1 * c
    img = np.repeat(img[:, :, None], 3, axis=2)
    img += rng.uniform(-0.1, 0.1, (1, 1, 3))
    if rng.random() < 0.8:
        fx, fy = rng.uniform(0.05, 0.45, 2)
        ph = rng.uniform(0, 2 * np.pi)
        amp = rng.uniform(0.05, 0.25)
        tex = amp * np.sin(2 * np.pi * (fx * xx + fy * yy) + ph)
        img += tex[:, :, None] * rng.uniform(0.3, 1.0, (1, 1, 3))
    for _ in range(rng.integers(2, 6)):
        col = rng.uniform(0, 1, 3)
        x0, y0 = rng.integers(0, size, 2)
        if rng.random() < 0.5:
            w, h = rng.integers(size // 8, size // 2, 2)
            img[y0:y0 + h, x0:x0 + w] = 0.6 * img[y0:y0 + h, x0:x0 + w] + 0.4 * col
        else:
            r = rng.integers(size // 10, size // 3)
            mask = (yy - y0) ** 2 + (xx - x0) ** 2 < r * r
            img[mask] = 0.5 * img[mask] + 0.5 * col
    for _ in range(rng.integers(1, 5)):
        y = rng.integers(0, size - 2)
        x0, x1 = sorted(rng.integers(0, size, 2))
        img[y:y + rng.integers(1, 3), x0:x1] = rng.uniform(0, 1)
    img += rng.standard_normal((size, size, 3)) * 0.01
    return np.clip(img, 0, 1).astype(np.float32)


def _gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    if sigma <= 0.05:
        return img
    r = max(1, int(3 * sigma))
    x = np.arange(-r, r + 1)
    k = np.exp(-x * x / (2 * sigma * sigma))
    k /= k.sum()
    out = img
    out = np.apply_along_axis(
        lambda m: np.convolve(np.pad(m, r, mode="edge"), k, "valid"), 0, out)
    out = np.apply_along_axis(
        lambda m: np.convolve(np.pad(m, r, mode="edge"), k, "valid"), 1, out)
    return out.astype(np.float32)


def degrade(rng: np.random.Generator, hr: np.ndarray, scale: int) -> np.ndarray:
    """HR (H, W, 3) -> LR (H/s, W/s, 3): random blur, area downsample,
    noise, 8-bit quantization."""
    img = _gaussian_blur(hr, rng.uniform(0.0, 1.6))
    h, w, _ = img.shape
    lr = img.reshape(h // scale, scale, w // scale, scale, 3).mean((1, 3))
    if rng.random() < 0.7:
        lr = lr + rng.standard_normal(lr.shape) * rng.uniform(0.0, 0.03)
    lr = np.round(np.clip(lr, 0, 1) * 255.0) / 255.0
    return lr.astype(np.float32)


def make_sr_batch(rng: np.random.Generator, batch: int, hr_size: int,
                  scale: int) -> Tuple[np.ndarray, np.ndarray]:
    hrs = np.stack([synth_hr_patch(rng, hr_size) for _ in range(batch)])
    lrs = np.stack([degrade(rng, h, scale) for h in hrs])
    return lrs, hrs


def add_noise(rng: np.random.Generator, clean: np.ndarray) -> np.ndarray:
    """Clean (H, W, 3) -> noisy: gaussian (sometimes luma-shaped, like film
    grain), occasional impulses, 8-bit quantization."""
    sigma = rng.uniform(0.02, 0.12)
    n = rng.standard_normal(clean.shape).astype(np.float32)
    if rng.random() < 0.4:
        luma = clean.mean(-1, keepdims=True)
        n *= (0.5 + 2.0 * luma * (1.0 - luma)).astype(np.float32)
    noisy = clean + sigma * n
    if rng.random() < 0.2:
        m = rng.random(clean.shape[:2]) < 0.002
        noisy[m] = rng.random((int(m.sum()), 1)).astype(np.float32)
    noisy = np.round(np.clip(noisy, 0, 1) * 255.0) / 255.0
    return noisy.astype(np.float32)


def make_denoise_batch(rng: np.random.Generator, batch: int,
                       size: int) -> Tuple[np.ndarray, np.ndarray]:
    cleans = np.stack([synth_hr_patch(rng, size) for _ in range(batch)])
    noisys = np.stack([add_noise(rng, c) for c in cleans])
    return noisys, cleans


# ---------------------------------------------------------------------------
# The training scaffold
# ---------------------------------------------------------------------------


class _ExamplePool:
    """Training examples: with ``size > 0`` a pool held on the device (one
    upload, regenerated at ``step % refresh == 0``), gathered with JAX's
    ``rng.integers`` indices; with ``size == 0`` host batches each step."""

    def __init__(self, make_batch, rng: np.random.Generator, device: torch.device,
                 size: int = 0, refresh: int = 0):
        self._make, self._rng, self._dev = make_batch, rng, device
        self._size, self._refresh = size, refresh
        self._pool = self._upload(make_batch(rng, size)) if size else None

    def _upload(self, arrays) -> Tuple[torch.Tensor, ...]:
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self._dev) for a in arrays)

    def sample(self, batch: int, step: int) -> Tuple[torch.Tensor, ...]:
        if self._pool is None:
            return self._upload(self._make(self._rng, batch))
        if self._refresh and step % self._refresh == 0:
            self._pool = self._upload(self._make(self._rng, self._size))
        idx = torch.from_numpy(self._rng.integers(0, self._size, batch).astype(np.int64))
        idx = idx.to(self._dev)
        return tuple(p.index_select(0, idx) for p in self._pool)


class Adam:
    """``optax.adam(optax.cosine_decay_schedule(lr, steps, alpha))``: b1 0.9,
    b2 0.999, eps 1e-8, eps_root 0; update k (from 1) moves by the rate at
    count k - 1, so the first uses ``lr``."""

    def __init__(self, params: List[torch.Tensor], lr: float, steps: int,
                 alpha: float = 0.1, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = [p for p in params if p.requires_grad]
        self.lr, self.steps, self.alpha = lr, steps, alpha
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def rate(self, count: int) -> float:
        """The cosine schedule at ``count``."""
        c = min(count, self.steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / self.steps))
        return self.lr * ((1.0 - self.alpha) * cosine + self.alpha)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        rate = self.rate(self.count)
        self.count += 1
        # optax's bias corrections in f32: f32(b2) is 1.3e-8 off 0.999,
        # which 1 - b2 ** count turns into ~1e-5 of the update
        one, k = np.float32(1.0), self.count
        bc1 = float(one - np.float32(self.b1) ** k)
        bc2 = float(one - np.float32(self.b2) ** k)
        for p, m, v in zip(self.params, self.mu, self.nu):
            g = p.grad if p.grad is not None else torch.zeros_like(p)   # unused: JAX's zeros
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).add_(g * g, alpha=1.0 - self.b2)
            p.sub_(rate * ((m / bc1) / ((v / bc2).sqrt() + self.eps)))


def _train(params: List[torch.Tensor], lr: float, steps: int, step_loss: Callable,
           log_every: int, report: Optional[dict]) -> None:
    """The shared loop: ``step_loss(step)`` builds a step's loss (the
    forward in full f32), then the backward in full f32 and one Adam
    update, all under ``hw.deterministic``; JAX's log lines."""
    opt = Adam(params, lr, steps)
    losses = []
    with deterministic() as nondeterministic:
        for step in range(1, steps + 1):
            with full_f32():
                loss = step_loss(step)
            opt.zero_grad()
            with full_f32():
                loss.backward()
            opt.step()
            losses.append(loss.detach())
            if log_every and step % log_every == 0:
                print(f"step {step}: loss {float(loss.detach()):.5f}", flush=True)
    if report is not None:
        report["losses"] = [float(v) for v in losses]
        report["nondeterministic_ops"] = nondeterministic


def _leaf_tree(tree, device: torch.device):
    """A JAX tree of numpy arrays -> trainable f32 leaves on ``device``
    (``layers.tree_to_torch``'s layouts: conv weights OIHW, channels-last)."""
    from framewright_tpu_torch.models.layers import tree_to_torch

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return None if node is None else node.detach().clone().requires_grad_(True)

    return walk(tree_to_torch(tree, device, torch.float32))


def _tree_leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tree_leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _tree_leaves(v)]
    return [] if tree is None else [tree]


def _numpy_tree(tree, key: str = ""):
    """The inverse of ``_leaf_tree``: conv weights back to HWIO, f32 numpy."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v, key) for v in tree]
    if tree is None:
        return None
    a = tree.detach().float().cpu()
    if key == "w" and a.ndim == 4:                       # (O, I, kh, kw) -> (kh, kw, I, O)
        a = a.permute(2, 3, 1, 0)
    return np.ascontiguousarray(a.numpy())


def _module(family: str, cfg, params: Dict, device: torch.device):
    """The family's module from a JAX tree, its parameters trainable."""
    from framewright_tpu_torch.models.registry import from_jax_params

    sd = from_jax_params(params, torch.float32)
    if family == "rrdb":
        from framewright_tpu_torch.models.rrdb import RRDBNet as net
    elif family == "srvgg":
        from framewright_tpu_torch.models.srvgg import SRVGGNet as net
    else:
        from framewright_tpu_torch.models.nafnet import NAFNet as net
    return net.from_state_dict(cfg, sd, device).requires_grad_(True)


# ---------------------------------------------------------------------------
# Student training (supervised or distilled)
# ---------------------------------------------------------------------------


def train_student(student_cfg=None, steps: int = 1500, batch: int = 8, hr_size: int = 128,
                  lr: float = 2e-4, seed: int = 0, mode: str = "synthetic",
                  teacher: Optional[Tuple[Dict, object]] = None, log_every: int = 0,
                  params: Optional[Dict] = None, pool_size: int = 0, pool_refresh: int = 0,
                  arch: str = "rrdb", device="auto", report: Optional[dict] = None) -> Dict:
    """Train a student SR net -> its parameters (f32 numpy, JAX's layout).

    ``arch`` rrdb (default ``RRDBConfig(num_block=6, scale=2)``) or srvgg
    (``SRVGGConfig(num_conv=16, scale=2)``); ``mode`` synthetic (L1 to the
    HR patch) or distill (L1 to the RRDB ``teacher=(params, cfg)``'s plain
    f32 output, plus 0.1 L1 to the HR patch)."""
    from framewright_tpu_torch.models import rrdb, srvgg
    from framewright_tpu_torch.models.registry import to_jax_params

    dev = resolve_device(device)
    if arch == "srvgg":
        cfg = student_cfg or srvgg.SRVGGConfig(num_conv=16, scale=2)
        stacked = False
        params = params if params is not None else srvgg.jax_init(cfg, seed)
    elif arch == "rrdb":
        cfg = student_cfg or rrdb.RRDBConfig(num_block=6, scale=2)
        params = params if params is not None else rrdb.stack_body(rrdb.jax_init(cfg, seed))
        stacked = not isinstance(params["body"], list)
    else:
        raise ValueError(f"arch must be rrdb or srvgg, got {arch!r}")
    if mode not in ("synthetic", "distill"):
        raise ValueError(f"mode must be synthetic or distill, got {mode!r}")
    rng = np.random.default_rng(seed)
    net = _module(arch, cfg, params, dev)
    teacher_net = None
    if mode == "distill":
        t_params, t_cfg = teacher
        teacher_net = _module("rrdb", t_cfg, t_params, dev).requires_grad_(False)
    pool = _ExamplePool(lambda r, n: make_sr_batch(r, n, hr_size, cfg.scale), rng, dev,
                        pool_size, pool_refresh)

    def step_loss(step: int) -> torch.Tensor:
        lr_b, gt_b = pool.sample(batch, step)
        if teacher_net is None:
            return (net.apply(lr_b) - gt_b).abs().mean()
        with torch.no_grad():
            tgt = teacher_net.apply(lr_b)
        out = net.apply(lr_b)
        return (out - tgt).abs().mean() + 0.1 * (out - gt_b).abs().mean()

    _train(list(net.parameters()), lr, steps, step_loss, log_every, report)
    return to_jax_params(net.state_dict(), stacked=stacked)


# ---------------------------------------------------------------------------
# The diffusion SR and the denoiser
# ---------------------------------------------------------------------------


def train_diffusion(cfg=None, steps: int = 2000, batch: int = 8, hr_size: int = 64,
                    lr: float = 3e-4, seed: int = 0, log_every: int = 0,
                    params: Optional[Dict] = None, pool_size: int = 0, pool_refresh: int = 0,
                    t_bias: float = 0.0, device="auto", report: Optional[dict] = None) -> Dict:
    """Train the diffusion SR net (x0 prediction) on synthetic
    degradations: L1 of the predicted x0 at a random t of the cosine
    schedule. ``t_bias``: the share of a batch drawn near the DDIM
    sampler's own timesteps (+-5% jitter) instead of uniformly."""
    from framewright_tpu_torch.models import diffusion_sr
    from framewright_tpu_torch.models.layers import resize_bicubic

    dev = resolve_device(device)
    cfg = cfg or diffusion_sr.DiffusionSRConfig()
    rng = np.random.default_rng(seed)
    tree = _leaf_tree(params if params is not None else diffusion_sr.jax_init(cfg, seed), dev)
    acp = torch.from_numpy(diffusion_sr.alphas_cumprod(cfg.train_steps)).to(dev)
    pool = _ExamplePool(lambda r, n: make_sr_batch(r, n, hr_size, cfg.scale), rng, dev,
                        pool_size, pool_refresh)

    def step_loss(step: int) -> torch.Tensor:
        lr_b, hr_b = pool.sample(batch, step)
        t_np = rng.integers(0, cfg.train_steps, batch)
        if t_bias:
            grid = np.linspace(cfg.train_steps - 1, 0, cfg.steps + 1)[:-1]
            pick = rng.random(batch) < t_bias
            jit_t = (grid[rng.integers(0, len(grid), batch)]
                     + rng.integers(-cfg.train_steps // 20, cfg.train_steps // 20 + 1, batch))
            t_np = np.where(pick, np.clip(jit_t, 0, cfg.train_steps - 1), t_np)
        t_idx = torch.from_numpy(np.asarray(t_np).astype(np.int64)).to(dev)
        noise = torch.from_numpy(
            rng.standard_normal((batch, hr_size, hr_size, 3)).astype(np.float32)).to(dev)
        cond = resize_bicubic(lr_b, (lr_b.shape[1] * cfg.scale, lr_b.shape[2] * cfg.scale))
        a = acp[t_idx][:, None, None, None]
        x0 = hr_b * 2.0 - 1.0
        x_noisy = torch.sqrt(a) * x0 + torch.sqrt(1 - a) * noise
        t_frac = t_idx.float() / cfg.train_steps
        pred = diffusion_sr.denoise(tree, x_noisy, cond * 2.0 - 1.0, t_frac, cfg)
        return (pred - x0).abs().mean()

    _train(_tree_leaves(tree), lr, steps, step_loss, log_every, report)
    return _numpy_tree(tree)


def train_denoiser(cfg=None, steps: int = 3000, batch: int = 16, size: int = 64,
                   lr: float = 2e-4, seed: int = 0, log_every: int = 0,
                   params: Optional[Dict] = None, pool_size: int = 0, pool_refresh: int = 0,
                   device="auto", report: Optional[dict] = None) -> Dict:
    """Train a NAFNet denoiser (default ``FW_nafnet_dn``'s config) on
    synthetic noise mixtures: L1 to the clean patch."""
    from framewright_tpu_torch.models import nafnet
    from framewright_tpu_torch.models.registry import to_jax_params

    dev = resolve_device(device)
    cfg = cfg or nafnet.NAFNetConfig(width=16, enc_blocks=(1, 1, 2), middle_blocks=2,
                                     dec_blocks=(1, 1, 1))
    rng = np.random.default_rng(seed)
    net = _module("nafnet", cfg, params if params is not None else nafnet.jax_init(cfg, seed),
                  dev)
    pool = _ExamplePool(lambda r, n: make_denoise_batch(r, n, size), rng, dev,
                        pool_size, pool_refresh)

    def step_loss(step: int) -> torch.Tensor:
        noisy_b, clean_b = pool.sample(batch, step)
        out = net(noisy_b.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return (out - clean_b).abs().mean()

    _train(list(net.parameters()), lr, steps, step_loss, log_every, report)
    return to_jax_params(net.state_dict())


def finetune_sampler(cfg=None, steps: int = 3000, batch: int = 8, hr_size: int = 64,
                     lr: float = 1e-4, seed: int = 0, log_every: int = 0,
                     params: Optional[Dict] = None, pool_size: int = 0, pool_refresh: int = 0,
                     device="auto", report: Optional[dict] = None) -> Dict:
    """Fine-tune the diffusion net through the DDIM sampler: the MSE of
    ``ddim_sample``'s output against the HR patch, a fresh JAX key
    ``PRNGKey(rng.integers(0, 2**31))`` a batch for the sampler's noise."""
    from framewright_tpu_torch.models import diffusion_sr

    dev = resolve_device(device)
    cfg = cfg or diffusion_sr.DiffusionSRConfig()
    rng = np.random.default_rng(seed)
    tree = _leaf_tree(params if params is not None else diffusion_sr.jax_init(cfg, seed), dev)
    pool = _ExamplePool(lambda r, n: make_sr_batch(r, n, hr_size, cfg.scale), rng, dev,
                        pool_size, pool_refresh)

    def step_loss(step: int) -> torch.Tensor:
        lr_b, hr_b = pool.sample(batch, step)
        key = int(rng.integers(0, 2**31))
        out = diffusion_sr.ddim_sample(tree, lr_b, cfg, seed=key)
        return ((out - hr_b) ** 2).mean()

    _train(_tree_leaves(tree), lr, steps, step_loss, log_every, report)
    return _numpy_tree(tree)


# ---------------------------------------------------------------------------
# Evaluation (the PSNR gates) and checkpoints
# ---------------------------------------------------------------------------


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((np.clip(a, 0, 1) - b) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


def eval_psnr(apply_fn: Callable, scale: int, n: int = 8, hr_size: int = 128,
              seed: int = 123, device="auto") -> Tuple[float, float]:
    """-> (psnr of ``apply_fn``, psnr of the bicubic upscale) on held-out
    synthetic pairs; ``apply_fn`` takes the LR batch (N, h, w, 3) f32 on
    ``device``."""
    from framewright_tpu_torch.models.layers import resize_bicubic

    dev = resolve_device(device)
    lrs, hrs = make_sr_batch(np.random.default_rng(seed), n, hr_size, scale)
    x = torch.from_numpy(lrs).to(dev)
    with torch.no_grad(), full_f32():
        out = apply_fn(x).float().cpu().numpy()
        bic = resize_bicubic(x, (lrs.shape[1] * scale, lrs.shape[2] * scale)).cpu().numpy()
    return _psnr(out, hrs), _psnr(bic, hrs)


def eval_denoise_psnr(apply_fn: Callable, n: int = 16, size: int = 64, seed: int = 123,
                      device="auto") -> Tuple[float, float]:
    """-> (psnr of ``apply_fn``, psnr of the noisy input) on held-out pairs."""
    dev = resolve_device(device)
    noisys, cleans = make_denoise_batch(np.random.default_rng(seed), n, size)
    with torch.no_grad(), full_f32():
        out = apply_fn(torch.from_numpy(noisys).to(dev)).float().cpu().numpy()
    return _psnr(out, cleans), _psnr(noisys, cleans)


def save_npz(params: Dict, path: Path) -> Path:
    """A trained tree in the JAX package's ``.npz`` layout
    (``registry.write_npz``), which both packages read."""
    from framewright_tpu_torch.models.registry import write_npz

    return write_npz(params, Path(path))
