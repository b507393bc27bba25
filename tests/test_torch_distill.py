"""On-device training (``models/distill.py``) on the CPU against the JAX
package: the synthetic data and the pool's sampling bit for bit, each
family's ``jax_init`` against JAX's ``init(PRNGKey(seed))``, the
``to_jax_params`` round trip, every trainer over 3 steps on tiny configs
from the same seed (the SRVGG student's distill mode and the U-net
trainers are in ``test_torch_distill_unets.py``; each step's loss within 1e-4 relative; after k steps
the parameters' mean |delta| <= 0.01 lr k and max |delta| <= 2 lr k: a
gradient near zero whose sign differs moves a parameter by up to 2 lr
under Adam), and ``save_npz`` read back by JAX's ``import_npz``."""

import builtins

import jax
import numpy as np
import pytest
import torch

from framewright_tpu.models import diffusion_sr as jdiff
from framewright_tpu.models import distill as jd
from framewright_tpu.models import nafnet as jnaf
from framewright_tpu.models import rrdb as jrrdb
from framewright_tpu.models import srvgg as jsrvgg
from framewright_tpu.models import torch_port
from framewright_tpu_torch.errors import DeviceError
from framewright_tpu_torch.models import diffusion_sr, distill, nafnet, registry, rrdb, srvgg

STEPS = 3
DIFF = dict(base_ch=8, ch_mults=(1, 2), time_dim=16, steps=2, scale=2)


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _pairs(a, b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    return [(p, x, y) for (p, x), (_, y) in zip(la, lb)]


def _ulps(a, b) -> int:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32)).max()) if a.size else 0


def _jax_losses(monkeypatch, module):
    """The losses JAX's trainer logs with ``log_every=1``, unrounded: its
    module's ``float`` records what it converts."""
    seen = []

    def rec(x):
        seen.append(float(np.asarray(x)))
        return builtins.float(x)

    monkeypatch.setattr(module, "float", rec, raising=False)
    return seen


def _hold(jax_tree, port_tree, jax_losses, report, lr, k=STEPS):
    assert len(jax_losses) == len(report["losses"]) == k
    for want, got in zip(jax_losses, report["losses"]):
        assert abs(got - want) <= 1e-4 * abs(want), (jax_losses, report["losses"])
    d = np.concatenate([np.abs(np.asarray(x, np.float32) - np.asarray(y, np.float32)).ravel()
                        for _, x, y in _pairs(jax_tree, port_tree) if x is not None])
    assert d.mean() <= 0.01 * lr * k and d.max() <= 2 * lr * k, (d.mean(), d.max())


# -- data ----------------------------------------------------------------------------

def test_data_is_jax_bit_for_bit():
    for make in ("make_sr_batch", "make_denoise_batch"):
        args = (3, 32, 2) if make == "make_sr_batch" else (3, 32)
        ra, rb = np.random.default_rng(11), np.random.default_rng(11)
        for _ in range(2):
            for x, y in zip(getattr(jd, make)(ra, *args), getattr(distill, make)(rb, *args)):
                assert x.dtype == y.dtype == np.float32 and np.array_equal(x, y)
        assert ra.random() == rb.random()


def test_pool_samples_as_jax():
    """The device pool (size 6, refreshed every 2 steps) gathers the same
    examples as JAX's ``_ExamplePool`` from the same generator."""
    make = lambda r, n: jd.make_sr_batch(r, n, 16, 2)            # noqa: E731
    jp = jd._ExamplePool(make, np.random.default_rng(5), size=6, refresh=2)
    pp = distill._ExamplePool(make, np.random.default_rng(5), torch.device("cpu"),
                              size=6, refresh=2)
    for step in range(1, 5):
        for x, y in zip(jp.sample(3, step), pp.sample(3, step)):
            assert np.array_equal(np.asarray(x), y.numpy())
    host = distill._ExamplePool(make, np.random.default_rng(5), torch.device("cpu"))
    want = make(np.random.default_rng(5), 2)
    assert all(np.array_equal(a, b.numpy()) for a, b in zip(want, host.sample(2, 1)))


# -- inits and layouts ---------------------------------------------------------------

def _jax_init(init, cfg, seed):
    """JAX's ``init(PRNGKey(seed), cfg)``, jitted (one program, not
    hundreds of eager ones; the draws are jitted either way)."""
    return jax.tree_util.tree_map(np.asarray, jax.jit(lambda k: init(k, cfg))(
        jax.random.PRNGKey(seed)))


NAF = dict(width=8, enc_blocks=(1, 1), middle_blocks=1, dec_blocks=(1, 1))
INITS = {
    "rrdb": (lambda: _jax_init(jrrdb.init, jrrdb.RRDBConfig(num_block=2, scale=2), 3),
             lambda: rrdb.jax_init(rrdb.RRDBConfig(num_block=2, scale=2), 3)),
    "srvgg": (lambda: _jax_init(jsrvgg.init, jsrvgg.SRVGGConfig(num_conv=4, scale=4), 4),
              lambda: srvgg.jax_init(srvgg.SRVGGConfig(num_conv=4, scale=4), 4)),
    "nafnet": (lambda: _jax_init(jnaf.init, jnaf.NAFNetConfig(**NAF), 5),
               lambda: nafnet.jax_init(nafnet.NAFNetConfig(**NAF), 5)),
    "diffusion": (lambda: _jax_init(jdiff.init, jdiff.DiffusionSRConfig(**DIFF), 6),
                  lambda: diffusion_sr.jax_init(diffusion_sr.DiffusionSRConfig(**DIFF), 6)),
}


@pytest.mark.parametrize("family", sorted(INITS))
def test_jax_init_draws_as_jax(family):
    """Uniforms (every conv) bit-equal; the diffusion time embedding's
    normals within 4 f32 ulps (XLA's erfinv)."""
    jax_fn, port_fn = INITS[family]
    for path, want, got in _pairs(jax_fn(), port_fn()):
        if want is None:
            assert got is None, path
            continue
        assert np.asarray(want).shape == got.shape and got.dtype == np.float32, path
        assert _ulps(want, got) <= (4 if "/temb/w" in path else 0), path


def test_to_jax_params_round_trip_is_exact():
    trees = [rrdb.jax_init(rrdb.RRDBConfig(num_block=2, scale=2), 1),
             srvgg.jax_init(srvgg.SRVGGConfig(num_conv=3, scale=2), 1),
             nafnet.jax_init(nafnet.NAFNetConfig(width=8, enc_blocks=(1, 2), middle_blocks=1,
                                                 dec_blocks=(1, 1)), 1)]
    stacked = rrdb.stack_body(trees[0])
    for tree, kw in [(t, {}) for t in trees] + [(stacked, {"stacked": True})]:
        back = registry.to_jax_params(registry.from_jax_params(tree, torch.float32), **kw)
        for path, want, got in _pairs(tree, back):
            assert np.array_equal(want, got) and got.dtype == np.float32, path


# -- trainers ------------------------------------------------------------------------

def _student_cfgs(arch):
    if arch == "rrdb":
        return jrrdb.RRDBConfig(num_block=1, scale=2), rrdb.RRDBConfig(num_block=1, scale=2)
    return jsrvgg.SRVGGConfig(num_conv=4, scale=2), srvgg.SRVGGConfig(num_conv=4, scale=2)


@pytest.mark.parametrize("arch,mode", [("rrdb", "synthetic"), ("rrdb", "distill"),
                                       ("srvgg", "synthetic")])
def test_train_student_matches_jax(arch, mode, monkeypatch):
    jcfg, pcfg = _student_cfgs(arch)
    kw = dict(steps=STEPS, batch=4, hr_size=48, seed=3, mode=mode, arch=arch)
    jteacher = pteacher = None
    if mode == "distill":
        tj = jrrdb.stack_body(_jax_init(jrrdb.init, jrrdb.RRDBConfig(num_block=2, scale=2), 9))
        jteacher = (tj, jrrdb.RRDBConfig(num_block=2, scale=2))
        pteacher = (tj, rrdb.RRDBConfig(num_block=2, scale=2))
    init = jrrdb.init if arch == "rrdb" else jsrvgg.init
    start = _jax_init(init, jcfg, 3)
    if arch == "rrdb":
        start = jrrdb.stack_body(start)
    losses = _jax_losses(monkeypatch, jd)
    want = jd.train_student(jcfg, teacher=jteacher, log_every=1, params=start, **kw)
    report = {}
    got = distill.train_student(pcfg, teacher=pteacher, device="cpu", report=report, **kw)
    if arch == "rrdb":
        assert not isinstance(got["body"], list)            # stacked, as JAX's
    _hold(want, got, losses, report, 2e-4)


def test_train_student_warm_start_keeps_the_layout():
    cfg = rrdb.RRDBConfig(num_block=1, scale=2)
    listed = rrdb.jax_init(cfg, 2)
    out = distill.train_student(cfg, steps=1, batch=2, hr_size=16, params=listed, device="cpu")
    assert isinstance(out["body"], list) and len(out["body"]) == 1
    with pytest.raises(ValueError, match="arch"):
        distill.train_student(cfg, steps=1, arch="hat", device="cpu")


def test_adam_follows_optax():
    """The update and the cosine schedule against ``optax.adam`` on one
    tensor over 4 steps (the rate at count k - 1 for update k)."""
    import optax

    g_seq = np.random.default_rng(0).standard_normal((4, 5)).astype(np.float32)
    p0 = np.random.default_rng(1).standard_normal(5).astype(np.float32)
    opt = optax.adam(optax.cosine_decay_schedule(0.1, 4, alpha=0.1))
    jp, state = jax.numpy.asarray(p0), opt.init(jax.numpy.asarray(p0))
    t = torch.from_numpy(p0.copy()).requires_grad_(True)
    adam = distill.Adam([t], 0.1, 4)
    for g in g_seq:
        upd, state = opt.update(jax.numpy.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        t.grad = torch.from_numpy(g)
        adam.step()
        assert np.allclose(t.detach().numpy(), np.asarray(jp), rtol=0, atol=1e-6)


def test_trainers_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError):
        distill.train_student(steps=1)
    with pytest.raises(DeviceError):
        distill.eval_psnr(lambda x: x, 2)


def test_save_npz_reads_back_in_jax(tmp_path):
    """Trained trees (RRDB stacked, SRVGG, the diffusion tree with its
    None leaves) written by ``save_npz`` read back with JAX's
    ``torch_port.import_npz`` as equal arrays, and in the port's
    ``read_npz``."""
    trees = {"rrdb": rrdb.stack_body(rrdb.jax_init(rrdb.RRDBConfig(num_block=2, scale=2), 0)),
             "srvgg": srvgg.jax_init(srvgg.SRVGGConfig(num_conv=2, scale=2), 0),
             "diff": diffusion_sr.jax_init(diffusion_sr.DiffusionSRConfig(**DIFF), 0)}
    for name, tree in trees.items():
        path = distill.save_npz(tree, tmp_path / f"{name}.npz")
        for back in (torch_port.import_npz(path), registry.read_npz(path)):
            for p, want, got in _pairs(tree, back):
                assert (want is None and got is None) or np.array_equal(want, got), (name, p)


def test_eval_psnr_gates_as_jax():
    """JAX's gate (``tests/test_distill.py``) on the packaged FW_fast6_x2
    through the plain f32 forward, 8 held-out 128-pixel pairs: the bicubic
    figure within 1e-4 dB of JAX's, the model's within 1e-3 dB (JAX's
    ``rrdb.apply``), and above bicubic + 0.5 dB."""
    import jax.numpy as jnp

    spec = registry.get_model("FW_fast6_x2")
    tree = registry.read_npz(registry.packaged_weights_dir() / "FW_fast6_x2.npz")
    net = rrdb.RRDBNet.from_state_dict(spec.arch_config,
                                       registry.from_jax_params(tree, torch.float32), "cpu")
    got = distill.eval_psnr(net.apply, 2, device="cpu")
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    fwd = jax.jit(lambda lr: jrrdb.apply(jtree, lr, jrrdb.RRDBConfig(num_block=6, scale=2)))
    want = jd.eval_psnr(fwd, 2)
    assert abs(got[1] - want[1]) < 1e-4 and abs(got[0] - want[0]) < 1e-3, (got, want)
    assert got[0] > got[1] + 0.5
