"""Weights of the PyTorch port: the bridge from the JAX package's RRDB
parameter pytrees to the port's state dicts, the port's own reader of
the package's .npz format, and its seeded random init."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from framewright_tpu.models import rrdb as jrrdb
from framewright_tpu.models import torch_port
from framewright_tpu.models.registry import packaged_weights_dir as jax_weights_dir
from framewright_tpu_torch.models import registry
from framewright_tpu_torch.models.rrdb import RRDBConfig, RRDBNet


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_params():
    cfg = jrrdb.RRDBConfig(num_block=2, scale=2)
    return jax.device_get(jrrdb.init(jax.random.PRNGKey(0), cfg, dtype=jnp.float32))


def _expected_names(num_block):
    names = [f"{c}.{k}" for c in ("conv_first", "conv_body", "conv_up1",
                                   "conv_up2", "conv_hr", "conv_last")
             for k in ("weight", "bias")]
    names += [f"body.{i}.rdb{r}.conv{k}.{p}" for i in range(num_block)
              for r in (1, 2, 3) for k in range(1, 6) for p in ("weight", "bias")]
    return set(names)


class TestFromJaxParams:
    def test_names_match_the_module(self, jax_params):
        sd = registry.from_jax_params(jax_params, torch.float32)
        assert set(sd) == _expected_names(2)
        with torch.device("meta"):
            module = RRDBNet(RRDBConfig(num_block=2, scale=2))
        assert set(sd) == set(module.state_dict())

    def test_shapes_and_values_are_oihw(self, jax_params):
        sd = registry.from_jax_params(jax_params, torch.float32)
        pairs = [("conv_first", jax_params["conv_first"]),
                 ("conv_last", jax_params["conv_last"]),
                 ("body.1.rdb3.conv5", jax_params["body"][1]["rdb3"]["conv5"]),
                 ("body.0.rdb2.conv2", jax_params["body"][0]["rdb2"]["conv2"])]
        for name, p in pairs:
            w = np.asarray(p["w"])                      # HWIO
            got = sd[name + ".weight"].numpy()
            assert got.shape == (w.shape[3], w.shape[2], w.shape[0], w.shape[1])
            np.testing.assert_array_equal(got, w.transpose(3, 2, 0, 1))
            np.testing.assert_array_equal(sd[name + ".bias"].numpy(),
                                          np.asarray(p["b"]))

    def test_stacked_body_equals_list_body(self, jax_params):
        stacked = jax.device_get(jrrdb.stack_body(jax_params))
        a = registry.from_jax_params(jax_params, torch.float32)
        b = registry.from_jax_params(stacked, torch.float32)
        for k in a:
            assert torch.equal(a[k], b[k]), k

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    def test_cast_to_compute_dtype(self, jax_params, dtype):
        sd = registry.from_jax_params(jax_params, dtype)
        assert all(v.dtype == dtype for v in sd.values())
        ref = torch.from_numpy(np.asarray(jax_params["conv_hr"]["w"]).transpose(3, 2, 0, 1).copy())
        assert torch.equal(sd["conv_hr.weight"], ref.to(dtype))


class TestNpzReader:
    def test_reads_packaged_checkpoint_like_import_npz(self):
        path = jax_weights_dir() / "FW_fast6_x2.npz"
        assert registry.packaged_weights_dir() / "FW_fast6_x2.npz" == path
        want = torch_port.import_npz(path)
        got = registry.read_npz(path)
        flat_w = jax.tree_util.tree_leaves_with_path(want)
        flat_g = jax.tree_util.tree_leaves_with_path(got)
        assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
        for (_, a), (_, b) in zip(flat_w, flat_g):
            assert a.dtype == b.dtype == np.float16
            np.testing.assert_array_equal(a, b)

    def test_stacked_body_bridges_to_six_blocks(self):
        params = registry.read_npz(registry.packaged_weights_dir() / "FW_fast6_x2.npz")
        sd = registry.from_jax_params(params, torch.float32)
        assert set(sd) == _expected_names(6)
        np.testing.assert_array_equal(
            sd["body.5.rdb3.conv5.weight"].numpy(),
            np.asarray(params["body"]["rdb3"]["conv5"]["w"][5], np.float32)
            .transpose(3, 2, 0, 1))

    def test_load_weights_order(self, tmp_path):
        spec, sd, source = registry.load_weights("FW_fast6_x2", weights_dir=tmp_path)
        assert source.endswith("FW_fast6_x2.npz") and spec.arch_config.num_block == 6
        _, _, source = registry.load_weights("RealESRGAN_x2plus", weights_dir=tmp_path)
        assert source == "random(seed=0)"
        with pytest.raises(Exception, match="No weights"):
            registry.load_weights("RealESRGAN_x2plus", weights_dir=tmp_path,
                                  allow_random=False)


class TestRandomInit:
    def test_matches_jax_init_layout_and_bounds(self, jax_params):
        ours = registry.init_params(RRDBConfig(num_block=2, scale=2), seed=3)
        jl = jax.tree_util.tree_leaves_with_path(jax_params)
        ol = jax.tree_util.tree_leaves_with_path(ours)
        assert [p for p, _ in jl] == [p for p, _ in ol]
        for (path, a), (_, b) in zip(jl, ol):
            assert a.shape == b.shape and b.dtype == np.float32, path

        def convs(node):
            if "w" in node:
                yield node
                return
            for v in (node if isinstance(node, list) else node.values()):
                yield from convs(v)

        for conv in convs(ours):       # Kaiming-uniform bounds of conv_init
            bound = np.sqrt(3.0 / (9 * conv["w"].shape[2]))
            for leaf in (conv["w"], conv["b"]):
                assert np.abs(leaf).max() <= bound
            assert np.abs(conv["w"]).max() > 0.9 * bound

    def test_seeded(self):
        cfg = RRDBConfig(num_block=1, scale=2)
        a = registry.init_params(cfg, seed=1)
        b = registry.init_params(cfg, seed=1)
        c = registry.init_params(cfg, seed=2)
        np.testing.assert_array_equal(a["conv_hr"]["w"], b["conv_hr"]["w"])
        assert not np.array_equal(a["conv_hr"]["w"], c["conv_hr"]["w"])

    def test_x2plus_spec(self):
        spec = registry.get_model("RealESRGAN_x2plus")
        assert (spec.scale, spec.arch_config.num_block, spec.arch_config.num_feat,
                spec.arch_config.num_grow_ch) == (2, 23, 64, 32)
        assert set(registry.MODEL_SPECS) == {
            "RealESRGAN_x2plus", "RealESRGAN_x4plus",
            "RealESRGAN_x4plus_anime_6B", "FW_fast6_x2", "FW_fastvgg_x2",
            "FW_fastvgg_x4", "realesr-animevideov3", "realesr-general-x4v3",
            "HAT_SRx4", "BasicVSR", "TVSR_x4", "DiffusionSR_x4"}


class TestProcessorFastWeights:
    """The SR processor loads every master weight and bias rounded to bf16
    once, as the JAX processor does (``init_model(dtype=bf16)``), so the
    kernels' weights equal those of ``rrdb.make_fast_params`` built from
    the JAX processor's bf16 host params, bit for bit."""

    def test_equal_to_make_fast_params_of_bf16_host_params(self, tmp_path):
        from framewright_tpu.models.registry import init_model
        from framewright_tpu_torch.ops import fused_rrdb
        from framewright_tpu_torch.processors.super_resolution import (
            SRConfig,
            SuperResolution,
        )

        sr = SuperResolution(SRConfig(model_name="FW_fast6_x2", device="cpu",
                                      weights_dir=str(tmp_path)))
        sr.setup(24, 32)
        fw = sr.model.fast_weights()
        _, host = init_model("FW_fast6_x2", weights_dir=tmp_path, dtype=jnp.bfloat16,
                             device=False)
        fast = jrrdb.make_fast_params(host)

        def same(got: torch.Tensor, want, name):
            want = np.asarray(want, np.float32)
            got = got.float().numpy().reshape(want.shape)
            np.testing.assert_array_equal(got, want, err_msg=name)

        bw = fast["body_wide"]
        for i, blk in enumerate(fw.body):
            for j, wts in enumerate(blk):
                for src, key in enumerate(("Wx", "W1", "W2", "W3", "W4")):
                    off, n = fused_rrdb._SOURCES[src]
                    rows = torch.cat([wts.w[k][..., off:off + n].reshape(wts.w[k].shape[0], -1)
                                      for k in range(src, 5)])
                    same(rows, bw[key][i, j], f"body {i} {j} {key}")
                same(torch.cat(wts.b), bw["b"][i, j], f"body {i} {j} b")
        t3 = fast["tail3_phase"]
        same(fw.cbody.w, t3["Ws"], "Ws")
        same(fw.cbody.b, t3["bs"], "bs")
        same(fw.tail.up1, t3["Wa0"], "Wa0")
        same(fw.tail.up1_b, t3["ba0"], "ba0")
        same(fw.tail.up2, t3["Wa"], "Wa")
        same(fw.tail.up2_b, t3["ba"], "ba")
        for ph in range(4):          # conv_hr and conv_last are the same in every phase
            same(fw.tail.hr, t3["Wb"][ph], f"Wb {ph}")
            same(fw.tail.last, t3["Wc"][ph], f"Wc {ph}")
        same(fw.tail.hr_b, t3["bb"], "bb")
        same(fw.tail.last_b, t3["bc"], "bc")
        # the head, which stays in F.conv2d, reads the same rounded values
        same(sr.model.conv_first.weight.permute(2, 3, 1, 0), host["conv_first"]["w"],
             "conv_first")
        same(sr.model.conv_first.bias, host["conv_first"]["b"], "conv_first b")
