import numpy as np
from collections import defaultdict
from hga_tpu.config import AssemblerConfig
from hga_tpu.io.encode import PackedReads
from hga_tpu.models.overlap import OverlapRecords
from hga_tpu.models import assembly as A
from hga_tpu.utils.compile_cache import enable_compile_cache
enable_compile_cache()

pr = PackedReads.load(".chip_smoke/scale_4.6mb/corrected.npz")
ov = OverlapRecords.load(".chip_smoke/scale_4.6mb/overlaps.npz")
cfg = AssemblerConfig(k=15, w=5, band=64, min_shared_minimizers=2,
                      min_overlap_len=500, min_identity=0.75,
                      min_contig_len=2000)
g = A.build_string_graph(ov, pr.n_reads, cfg)
print("raw edges", g.u.size, flush=True)
keep = A.reduce_graph(g, cfg, read_len=pr.length)
edges = [(int(u), int(v)) for u, v, k in zip(g.u, g.v, keep) if k]
score_of = {(int(u), int(v)): int(s) for u, v, s, k in zip(g.u, g.v, g.score, keep) if k}
print("reduced", len(edges), flush=True)
cleaned = A.clean_graph(g.n_nodes, edges, score_of, tip_max_len=cfg.tip_max_len)
print("cleaned", len(cleaned), flush=True)
out = defaultdict(list); ind = defaultdict(list)
for u, v in cleaned:
    out[u].append(v); ind[v].append(u)
nodes = set(out) | set(ind)
multi_out = [u for u in out if len(out[u]) > 1]
no_in = [n for n in nodes if n not in ind]
no_out = [n for n in nodes if n not in out]
print("nodes", len(nodes), "multi-out", len(multi_out), "multi-in",
      len([v for v in ind if len(ind[v]) > 1]), "sources", len(no_in),
      "sinks", len(no_out), flush=True)
starts = np.array([int(nm.split("_")[2]) for nm in pr.names])
tl = np.array([int(nm.split("_")[4]) for nm in pr.names])
for u in multi_out[:10]:
    r = u // 2
    tg = [(v // 2, int(starts[v // 2]), int(tl[v // 2]), v % 2) for v in out[u]]
    print("junction node", u, "read", r, "start", int(starts[r]), "len",
          int(tl[r]), "->", tg, flush=True)
# sources with truth positions (contig start points)
src = sorted(no_in, key=lambda n: starts[n // 2])
print("sources by truth pos:", [(n, int(starts[n // 2])) for n in src[:40]],
      flush=True)
