"""Same-window A/B: f32 vs bf16 Adam first moment on the device.

Interleaves rounds of the flagship train step (bench.py's
make_train_runner) with ``moments_dtype`` off and on, so drifts of the
device's speed (clocks, power limit) hit both configurations equally.
Usage: ``python scripts/moments_ab.py [n_rounds] [B] [G]``.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    n_rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    B = int(sys.argv[2]) if len(sys.argv) > 2 else 128
    G = int(sys.argv[3]) if len(sys.argv) > 3 else 4

    from bench import make_train_runner

    cfgs = {
        "f32_mu": dict(moments_dtype=None),
        "bf16_mu": dict(moments_dtype="bfloat16"),
    }
    runners = {}
    for name, kw in cfgs.items():
        t0 = time.time()
        runners[name] = make_train_runner(B=B, steps_per_dispatch=G, **kw)
        print(f"compiled {name} in {time.time() - t0:.1f}s", flush=True)

    n_steps = 8 * G  # 8 jitted dispatches per timed sample
    results = {k: [] for k in cfgs}
    for r in range(n_rounds):
        for name, run in runners.items():
            ups = run(n_steps)
            results[name].append(ups)
            print(f"round {r} {name}: {ups:,.0f} utts/sec", flush=True)

    print()
    for name, v in results.items():
        print(f"{name}: best {max(v):,.0f}  median {np.median(v):,.0f}  "
              f"spread {(max(v) - min(v)) / np.median(v):.3f}")
    rel = np.median(results["bf16_mu"]) / np.median(results["f32_mu"])
    print(f"bf16_mu / f32_mu (median): {rel:.4f}")


if __name__ == "__main__":
    main()
