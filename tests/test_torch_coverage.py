"""The port's coverage of the JAX package's public API, read with ``ast``.

Every public top-level name (function, class, module constant) and every
public method of a public class of ``framewright_tpu/`` must have a
same-named counterpart in the same module of ``framewright_tpu_torch/``
(resolved by import), or an entry in the table below: a counterpart under
another name (``COUNTERPARTS``, each resolved by import), or the reason
there is none (``REASONS``). Only the benchmark (ROADMAP A4) is work still
to do. A table entry whose name the port now has, or that JAX no longer
has, is stale and fails too. The same test fails on any import of
``jax`` or of ``framewright_tpu`` in the port or in ``chip_smoke.py``."""

from __future__ import annotations

import ast
import importlib
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

A4 = "A4: the port's benchmark waits for a benchmark PR (ROADMAP A4)"
TPU_CONST = "a TPU tile, lane or VMEM constant of the Pallas kernel; the port's CUDA kernels " \
            "set their own tiles in ops/csrc"
JAX_TWIN = "a torch twin that only JAX's tests build (JAX's verify checks rrdb, srvgg and hat); " \
           "the port's tests hold the model to JAX's own module, and its verify to " \
           "models.upstream_ref's builders"

# JAX name -> "port module:attribute path" of the same function under another name
COUNTERPARTS = {
    "hw.DeviceInfo.hbm_gb": "hw:CardInfo.memory_gb",
    "hw.HardwareInfo.hbm_per_device": "hw:HardwareInfo.memory_per_device",
    "io.color.yuv_to_rgb_jax": "io.color:yuv_to_rgb",
    "io.color.rgb_to_yuv_jax": "io.color:rgb_to_yuv",
    "models.codeformer.init": "models.codeformer:init_params",
    "models.codeformer.apply": "models.codeformer:CodeFormer.apply",
    "models.colorizer_net.init": "models.colorizer_net:init_params",
    "models.ddcolor.init": "models.ddcolor:init_params",
    "models.diffusion_sr.init": "models.diffusion_sr:jax_init",
    "models.gfpgan.init": "models.gfpgan:init_params",
    "models.gfpgan.apply": "models.gfpgan:GFPGAN.apply",
    "models.hat.init": "models.hat:init_params",
    "models.ifnet.init": "models.ifnet:init_params",
    "models.ifnet.apply": "models.ifnet:IFNet.apply",
    "models.ifnet.estimate_flow": "models.ifnet:IFNet.estimate_flow",
    "models.ifnet.interpolate_padded": "models.ifnet:IFNet.interpolate_padded",
    "models.lama.init": "models.lama:init_params",
    "models.nafnet.init": "models.nafnet:jax_init",
    "models.nafnet.apply": "models.nafnet:NAFNet.forward",
    "models.nafnet.apply_padded": "models.nafnet:NAFNet.apply_padded",
    "models.raft.init": "models.raft:init_params",
    "models.registry.ModelSpec.init": "models.registry:init_params",
    "models.registry.init_model": "models.registry:load_weights",
    "models.restormer.init": "models.restormer:init_params",
    "models.retinaface.init": "models.retinaface:init_params",
    "models.retinaface.apply": "models.retinaface:RetinaFace.apply",
    "models.rrdb.init": "models.rrdb:jax_init",
    "models.rrdb.apply": "models.rrdb:RRDBNet.apply",
    "models.rrdb.make_fast_params": "models.rrdb:RRDBNet.fast_weights",
    "models.rrdb.apply_fast": "models.rrdb:RRDBNet.apply_fast",
    "models.srvgg.init": "models.srvgg:jax_init",
    "models.srvgg.apply": "models.srvgg:SRVGGNet.apply",
    "models.tvsr.init": "models.tvsr:init_params",
    "models.vsr.init": "models.vsr:init_params",
    "models.torch_port.load_state_dict": "models.upstream_ref:load_state_dict",
    "models.torch_port.port_rrdb": "models.registry:to_jax_params",
    "models.torch_port.infer_rrdb_blocks": "models.upstream_ref:infer_rrdb_blocks",
    "models.torch_port.port_srvgg": "models.registry:to_jax_params",
    "models.torch_port.port_nafnet": "models.registry:to_jax_params",
    "models.torch_port.port_restormer": "models.restormer:port_state_dict",
    "models.torch_port.infer_lama_arch": "models.lama:infer_arch",
    "models.torch_port.port_lama": "models.lama:port_state_dict",
    "models.torch_port.port_ifnet": "models.ifnet:port_state_dict",
    "models.torch_port.infer_srvgg_convs": "models.upstream_ref:infer_srvgg_convs",
    "models.torch_port.port_gfpgan": "models.gfpgan:port_state_dict",
    "models.torch_port.port_basicvsr": "models.vsr:port_state_dict",
    "models.torch_port.port_hat": "models.hat:port_state_dict",
    "models.torch_port.port_retinaface": "models.retinaface:port_state_dict",
    "models.torch_port.port_raft": "models.raft:port_state_dict",
    "models.torch_port.port_codeformer": "models.codeformer:port_state_dict",
    "models.torch_port.export_npz": "models.registry:write_npz",
    "models.torch_port.import_npz": "models.registry:read_npz",
    "models.torch_ref.build_rrdbnet": "models.upstream_ref:build_rrdbnet",
    "models.torch_ref.build_srvgg": "models.upstream_ref:build_srvgg",
    "models.torch_ref.build_nafnet": "models.upstream_ref:build_nafnet",
    "models.torch_ref.build_restormer": "models.upstream_ref:build_restormer",
    "models.torch_ref.build_lama": "models.upstream_ref:build_lama",
    "models.torch_ref.build_hat": "models.upstream_ref:build_hat",
    "models.torch_ref.parity_check": "models.upstream_ref:parity_check",
    "ops.fused_rrdb.rdb_wide_weights": "ops.fused_rrdb:rdb_weights",
    "ops.fused_rrdb.rdb_wide_weights_int8": "ops.fused_rrdb:rdb_weights_int8",
    "ops.fused_rrdb.rdb_wide_weights_int8_i32": "ops.fused_rrdb:rdb_weights_int8_i32",
    "ops.fused_rrdb.fold_upconv_nearest2": "ops.fused_tail:up2_phase_weights",
    "ops.fused_rrdb.rrdb_fast_params": "models.rrdb:RRDBNet.fast_weights",
    "ops.fused_rrdb.fused_rdb_blocks": "ops.fused_rrdb:fused_rdb",
    "ops.fused_rrdb.fused_rdb_blocks_merge": "ops.fused_rrdb:fused_rdb",
    "ops.fused_rrdb.fused_rdb_blocks_int8": "ops.fused_rrdb:fused_rdb_int8",
    "ops.fused_rrdb.fused_rdb_blocks_merge_int8": "ops.fused_rrdb:fused_rdb_f32acc",
    "ops.fused_rrdb.fused_rdb_blocks_merge_int8_i32": "ops.fused_rrdb:fused_rdb_i32",
    "ops.fused_rrdb.rrdb_body_merge": "ops.fused_rrdb:rrdb_body",
    "ops.fused_rrdb.rrdb_body_merge_blocks": "ops.fused_rrdb:rrdb_body",
    "ops.fused_rrdb.rrdb_body_fast_roundtrip": "ops.fused_rrdb:rrdb_body_roundtrip",
    "ops.fused_rrdb.extract_blocks_concat": "ops.fused_rrdb:extract_blocks",
    "ops.fused_rrdb.halo_refresh_xla": "ops.fused_rrdb:halo_refresh_plain",
    "ops.fused_rrdb.halo_refresh_hbm": "ops.fused_rrdb:halo_refresh",
    "ops.fused_srvgg.make_fast_params": "models.srvgg:SRVGGNet.fast_weights",
    "ops.fused_srvgg.make_fast_params_int8": "models.srvgg:SRVGGNet.fast_weights_int8",
    "ops.fused_srvgg.calibrate_act_scales": "models.srvgg:calibrate_act_scales",
    "ops.fused_srvgg.apply_fast": "models.srvgg:SRVGGNet.apply_fast",
    "ops.fused_tail.tail_phase_weights": "ops.fused_tail:tail_weights",
    "ops.fused_tail.tail2_phase_weights": "ops.fused_tail:tail_weights",
    "ops.fused_tail.yuv420_matrix": "ops.fused_tail:yuv420_coefficients",
    "ops.fused_tail.fused_tail_blocks": "ops.fused_tail:fused_tail1",
    "ops.fused_tail.fused_tail_image": "ops.fused_tail:fused_tail1",
    "ops.fused_tail.fused_tail2_blocks": "ops.fused_tail:fused_tail",
    "ops.fused_tail.fused_tail2_image": "ops.fused_tail:fused_tail",
    "ops.fused_tail.PHASES": "ops.fused_tail:up2_phase_weights",
    "ops.fused_tail3.tail3_phase_weights": "ops.fused_tail:tail_weights",
    "ops.fused_tail3.tail3_image": "ops.fused_tail:fused_tail",
    "ops.fused_tail3.conv_body_skip_blocks": "ops.fused_tail3:conv_body_skip",
    "parallel.mesh.frame_sharding": "parallel.mesh:shard_frames",
    "planner.TilePlan": "planner:Plan",
    "planner.TilePlan.tiled": "planner:Plan.tiled",
    "planner.TilePlan.grid": "planner:Plan.grid",
    "planner.TilePlan.tiles_per_frame": "planner:Plan.tiles_per_frame",
    "planner.TilePlan.downshift": "planner:Plan.downshift",
    "planner.estimate_activation_bytes": "planner:frame_bytes",
    "safeguards.HBMMonitor": "safeguards:DeviceMemoryMonitor",
    "safeguards.HBMMonitor.check": "safeguards:DeviceMemoryMonitor.check",
    "safeguards.HBMMonitor.peak": "safeguards:DeviceMemoryMonitor.peak",
    "warmup.build_sr_config": "restorer:build_sr",
}

# JAX name (or a whole module) -> why the port has no counterpart
REASONS = {
    "benchmarks": A4,
    "cli.cmd_bench": A4,
    "cli.cmd_suite": A4,
    "cli.main_bench": A4,
    "cloud.TPUPodProvider": "rents a TPU VM, which has no CUDA card for the port's workers: "
                            "--burst gcp-tpu raises ConfigError",
    "cloud.TPUPodProvider.provision": "TPU VM provider (above)",
    "cloud.TPUPodProvider.status": "TPU VM provider (above)",
    "cloud.TPUPodProvider.terminate": "TPU VM provider (above)",
    "hw.HardwareInfo.peak_bf16_flops": "a TPU generation's peak from its device kind; the "
                                       "port states the H100's peaks in chip_smoke.py",
    "models.layers.count_params": "counts a JAX pytree's leaves (jax.tree_util); the port's "
                                  "networks are torch modules",
    "models.layers.tree_astype": "casts a JAX pytree (jax.tree_util); the port casts tensors "
                                 "and modules with .to (registry.bf16_masters)",
    "models.layers.spectral_pad": "jnp.pad of H and W; the port pads with F.pad where a "
                                  "module pads",
    "models.torch_port.port_tvsr": "no TVSR_x4 checkpoint is published: "
                                   "registry.port_checkpoint refuses the row",
    "ops.fused_rrdb.fold_conv_after_ps2": "no JAX path calls it (a fold of a conv after "
                                          "pixel_shuffle)",
    "ops.fused_rrdb.conv_after_ps2_apply": "no JAX path calls it (fold_conv_after_ps2's apply)",
    "parallel.dcn.global_mesh_devices": "JAX's device list across processes for one global "
                                        "mesh; each rank of the port runs its own cards",
    "parallel.mesh.replicate": "a JAX NamedSharding that replicates; the port copies weights "
                               "to each card it builds a member on",
    "warmup.default_cache_dir": "XLA's persistent compilation cache; the port's kernels are "
                                "built once into ops/_build",
    "warmup.enable_xla_cache": "XLA's persistent compilation cache (above)",
}
for _name in ("build_raft", "build_retinaface", "build_codeformer", "build_basicvsr",
              "build_ifnet", "build_gfpgan", "build_tvsr", "build_ddcolor"):
    REASONS[f"models.torch_ref.{_name}"] = JAX_TWIN
for _mod, _names in (("ops.fused_rrdb", ("PX", "NT", "TAPS", "TPC_NF", "TPC_GC", "TPC_NF_I8",
                                         "TPC_GC_I8", "TPC_NF_I32", "TPC_GC_I32", "VMEM_LIMIT",
                                         "HS")),
                     ("ops.fused_srvgg", ("S_V", "BH_V", "PX_V", "TAPS", "TPC", "VMEM_LIMIT")),
                     ("ops.fused_tail", ("S", "HALO", "BH", "PX", "S2", "HALO2", "BH2", "PX2")),
                     ("ops.pallas_conv", ("TAPS",))):
    for _name in _names:
        REASONS[f"{_mod}.{_name}"] = TPU_CONST


def public_names(pkg: str) -> dict:
    """module (dotted, relative to the package) -> its public top-level
    names and public methods of its public classes (``logger`` aside)."""
    out = {}
    for path in sorted((ROOT / pkg).rglob("*.py")):
        parts = list(path.relative_to(ROOT / pkg).with_suffix("").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names = []
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                if node.name.startswith("_"):
                    continue
                names.append(node.name)
                if isinstance(node, ast.ClassDef):
                    names += [f"{node.name}.{m.name}" for m in node.body
                              if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                              and not m.name.startswith("_")]
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                names += [t.id for t in targets if isinstance(t, ast.Name)
                          and not t.id.startswith("_") and t.id != "logger"]
        out[".".join(parts)] = names
    return out


def resolve(module: str, path: str) -> bool:
    """Whether ``framewright_tpu_torch.<module>`` has the attribute path."""
    try:
        obj = importlib.import_module("framewright_tpu_torch" + (f".{module}" if module else ""))
    except ModuleNotFoundError:
        return False
    for part in path.split("."):
        if not hasattr(obj, part):
            return False
        obj = getattr(obj, part)
    return True


JAX_NAMES = public_names("framewright_tpu")


def _missing():
    return [(m, n) for m, names in JAX_NAMES.items() for n in names if not resolve(m, n)]


def _entry(module: str, name: str):
    key = f"{module}.{name}" if module else name
    if key in COUNTERPARTS:
        return "counterpart", COUNTERPARTS[key]
    if key in REASONS:
        return "reason", REASONS[key]
    if module in REASONS:
        return "reason", REASONS[module]
    return None


def test_every_jax_name_has_a_counterpart_or_an_entry():
    missing = _missing()
    assert len(missing) > 100          # the renames and the JAX-only names
    unlisted = [f"{m}.{n}" for m, n in missing if _entry(m, n) is None]
    assert unlisted == []


@pytest.mark.parametrize("key", sorted(COUNTERPARTS))
def test_counterpart_resolves_by_import_and_the_name_is_missing(key):
    module, _, attr = COUNTERPARTS[key].partition(":")
    assert resolve(module, attr), COUNTERPARTS[key]
    jmod, name = _split(key)
    assert name in JAX_NAMES[jmod] and not resolve(jmod, name), f"stale entry {key}"


def _split(key: str):
    """``module.Name[.method]`` -> (JAX module, name) by the longest module."""
    parts = key.split(".")
    for i in range(len(parts) - 1, 0, -1):
        mod = ".".join(parts[:i])
        if mod in JAX_NAMES:
            return mod, ".".join(parts[i:])
    raise KeyError(key)


def test_reason_entries_are_still_missing_and_only_the_benchmark_is_a4():
    for key in REASONS:
        if key in JAX_NAMES:            # a whole module
            assert any(not resolve(key, n) for n in JAX_NAMES[key]), f"stale entry {key}"
            continue
        jmod, name = _split(key)
        assert name in JAX_NAMES[jmod] and not resolve(jmod, name), f"stale entry {key}"
    a4 = sorted(k for k, why in REASONS.items() if why.startswith("A4"))
    assert a4 == ["benchmarks", "cli.cmd_bench", "cli.cmd_suite", "cli.main_bench"]
    assert not set(COUNTERPARTS) & set(REASONS)


def test_the_slice_s_modules_are_ported():
    """The names this slice ports resolve under their JAX names."""
    for module in ("cloud", "uploads", "io.download", "errors", "testing", "engine.temporal",
                   "processors.base"):
        names = [n for n in JAX_NAMES[module] if _entry(module, n) is None]
        assert names and all(resolve(module, n) for n in names), module
    for module, name in (("ops.metrics", "ms_ssim"), ("ops.metrics", "quality_gate"),
                         ("processors.noise_profiler", "profile_frames"),
                         ("models.codeformer", "encode_indices"),
                         ("engine.checkpoint", "CheckpointManager.stage_started"),
                         ("engine.checkpoint", "CheckpointManager.is_stage_complete"),
                         ("processors.super_resolution", "SuperResolution.process_batch"),
                         ("processors.temporal_attention", "CrossFrameAttention.process_stream"),
                         ("processors.guided", "ClassicalGuidedBackend.process_stream"),
                         ("cli", "main_check"), ("cli", "cmd_upload")):
        assert resolve(module, name), (module, name)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_and_smoke_import_no_jax_and_nothing_of_framewright_tpu():
    files = sorted((ROOT / "framewright_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in ("jax", "jaxlib", "framewright_tpu"), (path, name)
        assert not re.search(r"import_module\(\s*['\"](jax|framewright_tpu)\b",
                             path.read_text()), path
