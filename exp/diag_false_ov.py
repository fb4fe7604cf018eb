"""Classify saved judged-scale overlaps as true/false vs simulator truth.

Reads .chip_smoke/scale_4.6mb/{corrected,overlaps}.npz; read names encode truth
loci (lr_{i}_{start}_{strand}_{genome_len}).  An overlap record is TRUE if
the two reads' genome intervals intersect by >= min_overlap_len.  Prints
the feature distributions (identity, segment length, score) of true vs
false records so the gate can be tuned to kill the false ones.
"""

import sys

import numpy as np

from hga_tpu.io.encode import PackedReads
from hga_tpu.models.overlap import OverlapRecords

rundir = sys.argv[1] if len(sys.argv) > 1 else ".chip_smoke/scale_4.6mb"
pr = PackedReads.load(f"{rundir}/corrected.npz")
ov = OverlapRecords.load(f"{rundir}/overlaps.npz")

starts = np.array([int(nm.split("_")[2]) for nm in pr.names], np.int64)
glen = np.array([int(nm.split("_")[4]) for nm in pr.names], np.int64)
ends = starts + glen

sa, ea = starts[ov.a], ends[ov.a]
sb, eb = starts[ov.b], ends[ov.b]
inter = np.minimum(ea, eb) - np.maximum(sa, sb)
true = inter >= 500

ident = ov.identity()
blk = np.maximum(ov.a_end - ov.a_start, ov.b_end - ov.b_start)

print(f"records: {ov.n}  true: {true.sum()}  false: {(~true).sum()}")
for name, m in (("TRUE ", true), ("FALSE", ~true)):
    if m.sum() == 0:
        continue
    print(f"{name}: n={m.sum()}")
    for fn, v in (("ident", ident), ("blk", blk), ("score", ov.score),
                  ("dist", ov.dist)):
        q = np.percentile(v[m], [0, 5, 25, 50, 75, 95, 100])
        print(f"  {fn:6s} " + " ".join(f"{x:9.3f}" for x in q))

# strand agreement on true overlaps: rel should equal strand_a ^ strand_b
strand = np.array([int(nm.split("_")[3]) for nm in pr.names], np.int8)
agree = (strand[ov.a] ^ strand[ov.b]) == ov.rel
print(f"strand-consistent: true {agree[true].mean():.4f} "
      f"false {agree[~true].mean() if (~true).any() else 1:.4f}")

# the false records in detail (first 20)
fi = np.nonzero(~true)[0][:20]
for i in fi:
    print(f"  false a={ov.a[i]}@{sa[i]} b={ov.b[i]}@{sb[i]} rel={ov.rel[i]} "
          f"blk={blk[i]} ident={ident[i]:.3f} dist={ov.dist[i]} "
          f"alen={ov.a_len[i]} blen={ov.b_len[i]} "
          f"a[{ov.a_start[i]}:{ov.a_end[i]}] b[{ov.b_start[i]}:{ov.b_end[i]}]")

# how does the false-ident histogram compare at various thresholds?
for thr in (0.75, 0.80, 0.85, 0.88, 0.90, 0.92):
    tk = (ident >= thr)[true].sum()
    fk = (ident >= thr)[~true].sum()
    print(f"ident>={thr:.2f}: keeps {tk}/{true.sum()} true, "
          f"{fk}/{(~true).sum()} false")
