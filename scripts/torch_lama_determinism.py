"""Whether LaMa gives the same bytes on every run on the card:

    python3 scripts/torch_lama_determinism.py [--runs 4]

Big-LaMa's widths (ngf 64, 3 downs, 18 blocks, global ratio 0.75) on
seeded weights, one 1080p frame of ``chip_smoke.py``'s texture with an
80x1500 hole, in f32 without TF32, as a restore runs it. Prints one JSON
line a case: of ``runs`` runs, how many differ bit for bit from the
first, how many values the worst of them differs in (f32, and after the
rounding to uint8) and by how much:

- each kind of LaMa operation alone at its 1080p shapes: the reflect-
  padded 7x7 head, a stride-2 conv, a 3x3 conv at the bottom's width, the
  Fourier unit (rfft2, 1x1 conv, irfft2), and each transposed conv both
  as cuDNN's ``conv_transpose2d`` and as ``models.lama._conv_transpose``
  (four forward convolutions);
- the whole network (``models.lama.apply_padded``) with either transposed
  conv: in this thread; in another thread on a CUDA stream of its own (as
  the restore's pre-SR stream runs it); beside an allocation that leaves
  the card twice LaMa's peak; with cuFFT's plan cache cleared before each
  run; and with ``torch.backends.cudnn.deterministic`` (against its own
  first run).

The last line: ``{"ok": true}`` when the port's network never differed."""

from __future__ import annotations

import argparse
import json
import sys
import threading
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402


def emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def cudnn_conv_transpose(p, x: torch.Tensor) -> torch.Tensor:
    """The transposed conv as cuDNN's ``conv_transpose2d`` (NHWC x)."""
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), p["w"].transpose(0, 1), p.get("b"),
                           stride=2, padding=1, output_padding=1)
    return y.permute(0, 2, 3, 1)


def compare(outs) -> dict:
    """outs[0] against each later output: runs that differ, the most
    values a run differs in (f32 and uint8) and the largest f32 gap."""
    ref = outs[0]
    ref_u8 = torch.floor(ref.clamp(0, 1) * 255.0 + 0.5)
    runs = n_f32 = n_u8 = 0
    gap = 0.0
    for o in outs[1:]:
        d = (o != ref).sum().item()
        runs += bool(d)
        n_f32 = max(n_f32, d)
        n_u8 = max(n_u8, (torch.floor(o.clamp(0, 1) * 255.0 + 0.5) != ref_u8).sum().item())
        gap = max(gap, (o - ref).abs().max().item())
    return {"runs": len(outs), "runs_differing": runs, "max_values_differing": n_f32,
            "max_u8_values_differing": n_u8, "max_abs": gap}


def repeat(fn, runs: int) -> list:
    outs = []
    for _ in range(runs):
        outs.append(fn())
        torch.cuda.synchronize()
    return outs


def in_thread(fn, runs: int) -> list:
    """``fn`` ``runs`` times in another thread, on a stream of its own."""
    outs: list = []

    def body():
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.default_stream())
        with torch.cuda.stream(stream):
            for _ in range(runs):
                outs.append(fn())
            stream.synchronize()

    t = threading.Thread(target=body)
    t.start()
    t.join()
    return outs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_lama_determinism: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import PROGRESSIVE, part_peak, synthetic_frames
    from framewright_tpu_torch.hw import full_f32
    from framewright_tpu_torch.models import lama
    from framewright_tpu_torch.models.layers import tree_to_torch

    dev = torch.device("cuda")
    runs = max(2, args.runs)
    cfg = lama.LamaConfig(ngf=64, n_down=3, n_blocks=18, global_ratio=0.75)
    p = tree_to_torch(lama.init_params(cfg, seed=31), dev, torch.float32)
    h, w = 1080, 1920
    img = torch.from_numpy(synthetic_frames(1, h, w, 100, **PROGRESSIVE)).to(dev).float() / 255.0
    mask = torch.zeros((1, h, w, 1), device=dev)
    mask[:, 900:980, 200:1700] = 1.0
    g = torch.Generator(device=dev).manual_seed(5)

    def rnd(*shape):
        return torch.rand(shape, generator=g, device=dev) * 2.0 - 1.0

    emit({"card": torch.cuda.get_device_name(0), "torch": torch.__version__,
          "cuda": torch.version.cuda, "cudnn": torch.backends.cudnn.version(),
          "cudnn_benchmark": torch.backends.cudnn.benchmark,
          "cudnn_deterministic": torch.backends.cudnn.deterministic})
    port_ok = True
    real = lama._conv_transpose
    with torch.no_grad(), full_f32():
        blk = p["blocks"][0]["ffc1"]
        x4, x64 = rnd(1, h, w, 4), rnd(1, h, w, 64)
        x128, z192 = rnd(1, 135, 240, 128), rnd(1, 135, 240, 192)
        ops = {"head 7x7 reflect, 4->64 at 1080x1920": lambda: lama._conv(p["head"], x4, reflect=3),
               "down 3x3 stride 2, 64->128 at 1080x1920":
                   lambda: lama._conv(p["downs"][0]["conv"], x64, stride=2),
               "3x3 128->384 at 135x240": lambda: lama._conv(blk["lg"], x128),
               "Fourier unit 192 ch at 135x240": lambda: lama._fourier_unit(blk["gg"]["fu"], z192)}
        for i, (hi, wi) in enumerate(((135, 240), (270, 480), (540, 960))):
            u = p["ups"][i]["conv"]
            xu = rnd(1, hi, wi, int(u["w"].shape[1]))
            size = f"{int(u['w'].shape[1])}->{int(u['w'].shape[0])} at {hi}x{wi}"
            ops[f"transposed conv {size}, cuDNN conv_transpose2d"] = (
                lambda u=u, xu=xu: cudnn_conv_transpose(u, xu))
            ops[f"transposed conv {size}, four forward convs"] = (
                lambda u=u, xu=xu: real(u, xu))
        for name, fn in ops.items():
            rec = compare(repeat(fn, runs))
            emit({"case": "op alone", "op": name, **rec})
            if "forward convs" in name:
                port_ok = port_ok and rec["runs_differing"] == 0

        def net():
            return lama.apply_padded(p, img, mask, cfg)

        for variant, ct in (("cuDNN conv_transpose2d", cudnn_conv_transpose),
                            ("four forward convs (the port)", real)):
            lama._conv_transpose = ct
            try:
                first, peak = part_peak(net)
                here = [first] + repeat(net, runs - 1)
                cases = {"this thread": here,
                         "another thread on its own stream": [first] + in_thread(net, runs)}
                torch.cuda.empty_cache()
                free, _ = torch.cuda.mem_get_info()
                fill = torch.empty(max(0, free - 2 * peak), dtype=torch.uint8, device=dev)
                cases["beside an allocation (twice the peak left)"] = [first] + repeat(net, runs)
                del fill
                torch.cuda.empty_cache()

                def cleared():
                    torch.backends.cuda.cufft_plan_cache.clear()
                    return net()

                cases["cuFFT plan cache cleared each run"] = [first] + repeat(cleared, runs)
                with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                                allow_tf32=False):
                    cases["cudnn.deterministic (against its own first run)"] = repeat(net, runs)
                for case, outs in cases.items():
                    rec = compare(outs)
                    emit({"case": case, "network": "LaMa 1080x1920", "transposed_conv": variant,
                          "peak_bytes": peak, **rec})
                    if variant.endswith("(the port)"):
                        port_ok = port_ok and rec["runs_differing"] == 0
            finally:
                lama._conv_transpose = real
    emit({"ok": port_ok})
    return 0 if port_ok else 1


if __name__ == "__main__":
    sys.exit(main())
