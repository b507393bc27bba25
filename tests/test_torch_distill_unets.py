"""The U-net trainers (``train_diffusion``, ``finetune_sampler``,
``train_denoiser``) and the SRVGG student's distill mode on the CPU
against the JAX package, 3 steps on tiny configs from the same seed, held
as ``test_torch_distill.py`` holds the RRDB students (a file apart: JAX
compiles each trainer for ~10 s on the CPU)."""

import pytest
import torch

from framewright_tpu.models import diffusion_sr as jdiff
from framewright_tpu.models import distill as jd
from framewright_tpu.models import nafnet as jnaf
from framewright_tpu.models import rrdb as jrrdb
from framewright_tpu.models import srvgg as jsrvgg
from framewright_tpu_torch.models import diffusion_sr, distill, nafnet, rrdb, srvgg

from test_torch_distill import DIFF, STEPS, _hold, _jax_init, _jax_losses


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_srvgg_student_distills_as_jax(monkeypatch):
    kw = dict(steps=STEPS, batch=4, hr_size=48, seed=3, mode="distill", arch="srvgg")
    tj = jrrdb.stack_body(_jax_init(jrrdb.init, jrrdb.RRDBConfig(num_block=2, scale=2), 9))
    start = _jax_init(jsrvgg.init, jsrvgg.SRVGGConfig(num_conv=4, scale=2), 3)
    losses = _jax_losses(monkeypatch, jd)
    want = jd.train_student(jsrvgg.SRVGGConfig(num_conv=4, scale=2), log_every=1, params=start,
                            teacher=(tj, jrrdb.RRDBConfig(num_block=2, scale=2)), **kw)
    report = {}
    got = distill.train_student(srvgg.SRVGGConfig(num_conv=4, scale=2), device="cpu",
                                report=report, teacher=(tj, rrdb.RRDBConfig(num_block=2, scale=2)),
                                **kw)
    _hold(want, got, losses, report, 2e-4)


def test_train_diffusion_matches_jax(monkeypatch):
    kw = dict(steps=STEPS, batch=4, hr_size=32, seed=5, t_bias=0.5)
    losses = _jax_losses(monkeypatch, jd)
    want = jd.train_diffusion(jdiff.DiffusionSRConfig(**DIFF), log_every=1, params=_jax_init(
        jdiff.init, jdiff.DiffusionSRConfig(**DIFF), 5), **kw)
    report = {}
    got = distill.train_diffusion(diffusion_sr.DiffusionSRConfig(**DIFF), device="cpu",
                                  report=report, **kw)
    _hold(want, got, losses, report, 3e-4)


def test_finetune_sampler_matches_jax(monkeypatch):
    kw = dict(steps=STEPS, batch=4, hr_size=32, seed=6)
    losses = _jax_losses(monkeypatch, jd)
    want = jd.finetune_sampler(jdiff.DiffusionSRConfig(**DIFF), log_every=1, params=_jax_init(
        jdiff.init, jdiff.DiffusionSRConfig(**DIFF), 6), **kw)
    report = {}
    got = distill.finetune_sampler(diffusion_sr.DiffusionSRConfig(**DIFF), device="cpu",
                                   report=report, **kw)
    _hold(want, got, losses, report, 1e-4)


def test_train_denoiser_matches_jax(monkeypatch):
    cfg = dict(width=8, enc_blocks=(1, 1), middle_blocks=1, dec_blocks=(1, 1))
    kw = dict(steps=STEPS, batch=4, size=32, seed=7)
    losses = _jax_losses(monkeypatch, jd)
    want = jd.train_denoiser(jnaf.NAFNetConfig(**cfg), log_every=1, params=_jax_init(
        jnaf.init, jnaf.NAFNetConfig(**cfg), 7), **kw)
    report = {}
    got = distill.train_denoiser(nafnet.NAFNetConfig(**cfg), device="cpu", report=report, **kw)
    _hold(want, got, losses, report, 2e-4)
