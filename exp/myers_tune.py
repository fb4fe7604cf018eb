"""Time the Pallas Myers kernel against the XLA engine on the GPU.

For each shape of the assembler's hot path the kernel is checked bit-exact
against ops/myers.py once, then every (block, num_warps, reload) setting is
timed beside the XLA engine.  Results go to stdout and, as JSON, to the
one argument ending in .json (default .chip_smoke/myers_tune.json).

    python -m exp.myers_tune                 # all shapes
    python -m exp.myers_tune gate planes     # a subset
    python -m exp.myers_tune gate out.json   # JSON to out.json
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

SHAPES = {
    # name: (N, Lq, Lt, planes)
    "gate": (8192, 112, 192, False),        # short-read overlap gate
    "planes": (4096, 112, 184, True),       # correction DP (bench_correction)
    "segment": (4096, 414, 478, False),     # long-read segment DP (SEG=384)
    "long": (4096, 744, 1024, False),       # W = 24, the kernel's cap
}


def main(argv):
    import jax
    import jax.numpy as jnp

    from hga_tpu.ops import myers as M
    from hga_tpu.ops import myers_pallas as MP
    from hga_tpu.utils.benchmarks import best_seconds
    from hga_tpu.utils.sim import dp_pairs

    if jax.default_backend() != "gpu":
        print(f"no GPU backend (got {jax.default_backend()!r})",
              file=sys.stderr)
        return 2
    dev = jax.devices()[0]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"device: {dev.device_kind} x{len(jax.devices())}; {smi.strip()}",
          flush=True)
    names = [a for a in argv if a in SHAPES] or list(SHAPES)
    rows = []
    for name in names:
        N, Lq, Lt, planes = SHAPES[name]
        W = M.n_words(Lq)
        args = tuple(jnp.asarray(x) for x in dp_pairs(N, Lq, Lt))
        ref_fn = M.myers_batch_planes if planes else M.myers_batch
        ker = MP.myers_batch_planes_pallas if planes else MP.myers_batch_pallas
        ref = jax.tree.map(np.asarray, ref_fn(*args))
        t_x = best_seconds(ref_fn, *args)
        cells = N * Lq * Lt
        print(f"{name}: N={N} Lq={Lq} (W={W}) Lt={Lt} planes={planes}: "
              f"xla {t_x * 1e3:.3f} ms ({cells / t_x / 1e9:.1f} GCUPS)",
              flush=True)
        rows.append(dict(shape=name, impl="xla", N=N, Lq=Lq, Lt=Lt, W=W,
                         seconds=t_x, gcups=cells / t_x / 1e9))
        reloads = (False, True) if W > 4 else (False,)
        for reload in reloads:
            for block in (128, 256, 512):
                for warps in (1, 2, 4, 8):
                    fn = lambda *a, b=block, w=warps, r=reload: ker(
                        *a, block=b, num_warps=w, reload=r)
                    t0 = time.perf_counter()
                    got = jax.tree.map(np.asarray, fn(*args))
                    t_c = time.perf_counter() - t0
                    for x, y in zip(jax.tree.leaves(got),
                                    jax.tree.leaves(ref)):
                        if not np.array_equal(x, y):
                            raise AssertionError(
                                f"{name} block={block} warps={warps} "
                                f"reload={reload}: kernel != XLA")
                    t_k = best_seconds(fn, *args)
                    print(f"  pallas block={block} warps={warps} "
                          f"reload={reload}: {t_k * 1e3:.3f} ms "
                          f"({cells / t_k / 1e9:.1f} GCUPS, x{t_x / t_k:.2f}"
                          f" vs xla; first call {t_c:.1f}s)", flush=True)
                    rows.append(dict(shape=name, impl="pallas", block=block,
                                     num_warps=warps, reload=reload, N=N,
                                     Lq=Lq, Lt=Lt, W=W, seconds=t_k,
                                     gcups=cells / t_k / 1e9))
    out = next((a for a in argv if a.endswith(".json")),
               ".chip_smoke/myers_tune.json")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as fh:
        json.dump(dict(device=dev.device_kind, nvidia_smi=smi.strip(),
                       rows=rows), fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
