"""Export trained decode functions as portable serving artifacts.

``python -m ast_tpu.cli.export_model -m <exp_dir> [--batch B]
[--frames T1,T2] [--beam N,K] [-o DIR]``

Loads the experiment's latest checkpoint (same auto-resume as the
train/beam CLIs), exports batched greedy decode — and, with ``--beam``,
beam decode — as self-contained StableHLO artifacts (weights baked in,
pure-XLA paths; see ast_tpu/serving.py), one per (batch, frames) shape,
plus ``manifest.json`` and a ``vocab.json`` id->token table so a server
can detokenize without pickles or framework code.

The reference has no deployment path at all (decode = the research CLI,
reference: beam.py:45-147); this is a new capability.
"""

import argparse
import os

import jax.numpy as jnp

from ast_tpu import serving
from ast_tpu.train.trainer import NN


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Export decode functions as StableHLO artifacts")
    parser.add_argument("-m", "--cfg_path", required=True)
    parser.add_argument("-o", "--out_dir", default=None,
                        help="output dir (default <exp>/serving)")
    parser.add_argument("--batch", type=int, default=32)
    parser.add_argument("--frames", default=None,
                        help="comma-separated input frame counts; "
                             "default: a 4-step ladder over the bucket "
                             "range (quarter points + the longest-"
                             "bucket cap), so short inputs are not "
                             "padded to the maximum length — the model "
                             "attends over padding unmasked, and "
                             "training bounds padding to a bucket "
                             "width")
    parser.add_argument("--beam", default=None, metavar="N,K",
                        help="additionally export beam decode at N,K")
    parser.add_argument("--stop-limit", type=int, default=None,
                        help="max decode steps (default data.max_pred)")
    parser.add_argument("--platforms",
                        default=",".join(serving.DEFAULT_PLATFORMS),
                        help="comma-separated jax.export lowering "
                             "platforms (default: %(default)s)")
    parser.add_argument("--dtype", default=None,
                        choices=["float32", "bfloat16"],
                        help="compute dtype inside the artifact "
                             "(default: the experiment's compute_dtype)")
    parser.add_argument("--ckpt", default=None,
                        help="export this checkpoint file instead of the "
                             "latest epoch (e.g. a copy_params --average "
                             "artifact)")
    parser.add_argument("--quantize", default=None, choices=["int8"],
                        help="bake weights as int8 constants (symmetric "
                             "per-output-channel, dequantized inside the "
                             "artifact) — ~4x smaller files")
    parser.add_argument("--quantize-min-size", type=int, default=4096,
                        help="only quantize weight tensors with at least "
                             "this many elements (default 4096)")
    args = parser.parse_args(argv)

    nn = NN(args.cfg_path, ckpt=args.ckpt)
    if nn.loaded_ckpt is None:
        print("warning: no checkpoint found — exporting the random init")
    data_cfg = nn.cfg.train["data"]
    stop_limit = args.stop_limit or int(data_cfg["max_pred"])
    platforms = [p.strip() for p in args.platforms.split(",") if p.strip()]
    dtype = (jnp.bfloat16 if args.dtype == "bfloat16"
             else jnp.float32 if args.dtype == "float32"
             else nn.compute_dtype)
    if args.frames:
        frames = [int(t) for t in args.frames.split(",")]
    else:
        n = int(data_cfg["buckets_num"])
        w = int(data_cfg["buckets_width"])
        # quarter-point ladder + the trainer's truncation cap
        # ((n+1)*w, dataloader max_sp) — the serving/infer selectors
        # pick the smallest fitting shape, keeping unmasked-attention
        # padding mass near training conditions
        frames = sorted({max(1, round(n * f)) * w
                         for f in (0.25, 0.5, 0.75)} | {(n + 1) * w})

    out_dir = args.out_dir or os.path.join(nn.model_dir, "serving")
    os.makedirs(out_dir, exist_ok=True)

    beam_nk = None
    if args.beam:
        try:
            beam_nk = tuple(int(v) for v in args.beam.split(","))
            if len(beam_nk) != 2:
                raise ValueError
        except ValueError:
            parser.error(f"--beam expects N,K (got {args.beam!r})")

    quant = bool(args.quantize)
    tag = "_q8" if quant else ""
    # quantize once; the export fns detect the pre-quantized tree
    params = (serving.quantize_params(nn.params, args.quantize_min_size)
              if quant else nn.params)
    entries = []
    for T in frames:
        exp = serving.export_greedy(
            params, nn.state, nn.mcfg, args.batch, T, stop_limit,
            dtype, platforms, quantize=quant,
            q_min_size=args.quantize_min_size)
        fname = f"greedy_B{args.batch}_T{T}{tag}.jaxexp"
        nbytes = serving.save_artifact(exp, os.path.join(out_dir, fname))
        entries.append({"file": fname, "kind": "greedy",
                        "batch": args.batch, "frames": T,
                        "platforms": platforms, "bytes": nbytes})
        print(f"exported {fname} ({nbytes} bytes, "
              f"platforms={','.join(platforms)})")
        if beam_nk:
            N, K = beam_nk
            exp = serving.export_beam(
                params, nn.state, nn.mcfg, args.batch, T, N, K,
                stop_limit, dtype, platforms, quantize=quant,
                q_min_size=args.quantize_min_size)
            fname = f"beam_N{N}_K{K}_B{args.batch}_T{T}{tag}.jaxexp"
            nbytes = serving.save_artifact(
                exp, os.path.join(out_dir, fname))
            entries.append({"file": fname, "kind": "beam", "N": N, "K": K,
                            "batch": args.batch, "frames": T,
                            "platforms": platforms, "bytes": nbytes})
            print(f"exported {fname} ({nbytes} bytes)")

    dec_key = data_cfg["dec_key"]
    i2w = nn.data_loader.dec_i2w
    mpath = serving.write_manifest(
        out_dir, entries, nn.mcfg, stop_limit,
        "bfloat16" if dtype == jnp.bfloat16 else "float32", i2w=i2w,
        dec_key=dec_key, quantization=args.quantize)
    print(f"manifest: {mpath}")
    return out_dir


if __name__ == "__main__":
    main()
