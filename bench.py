#!/usr/bin/env python
"""Print ONE JSON line: overlap-gate GCUPS on the engine dispatch picks.

The gate (models/overlap._edit_inner) runs every candidate pair through the
bit-parallel Myers DP: the Pallas kernel on the GPU, the XLA column loop
elsewhere.  The line names that engine (``impl``) and the device
(``platform``, ``device_kind``, ``device_count``); the scored-SW DP behind
overlap_refine = "sw" is reported beside it.
"""

import json
import sys


def main() -> int:
    from hga_tpu.utils.benchmarks import bench_myers, bench_sw, device_info

    res = bench_myers(n_pairs=8192)
    sw = bench_sw(n_pairs=4096)
    line = {
        "metric": "overlap_gate_gcups",
        "value": res["gcups"],
        "unit": "GCUPS",
        "impl": res["impl"],
        "shape": [res["n_pairs"], res["Lq"], res["Lt"]],
        "scored_sw_gcups": sw["gcups"],
        "scored_sw_impl": sw["impl"],
        **device_info(),
    }
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
