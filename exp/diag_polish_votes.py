"""Polish-stage vote forensics: at each rRNA copy-distinguishing site of
the assembled contig, what does the pileup actually vote — own-copy base or
family-master base?  Distinguishes candidate-misplacement averaging from
consensus logic bugs.

Usage: python -m exp.diag_polish_votes [contig_fasta] [genome_kb=1500]
"""

import sys

import numpy as np


def main():
    import logging

    logging.basicConfig(level=logging.WARNING)
    path = (sys.argv[1] if len(sys.argv) > 1
            else ".chip_smoke/scale_15rep_v2/contigs.fasta")
    gkb = float(sys.argv[2]) if len(sys.argv) > 2 else 1500.0

    from exp.diag_repeat_corr import derive
    from hga_tpu.config import AssemblerConfig
    from hga_tpu.io.encode import pack_reads, revcomp_str
    from hga_tpu.io.fastq import iter_records
    from hga_tpu.models import correction as MC
    from hga_tpu.models.spectrum import count_reads
    from hga_tpu.utils import sim
    from hga_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    genome, annot = sim.repeat_genome(int(gkb * 1000), seed=42,
                                      return_annotation=True)
    ss, sn = sim.simulate_short_reads(genome, coverage=30.0, read_len=100,
                                      error_rate=0.01, seed=43)
    pr_s = pack_reads(ss, names=sn, pad_len=112)
    contig = next(iter_records(path)).seq

    cfg0 = AssemblerConfig(k=15, w=5, band=64, batch_reads=4096,
                           min_shared_minimizers=2, min_overlap_len=500,
                           min_identity=0.75, corr_batch_pairs=4096)
    spec = count_reads(pr_s, cfg0)
    cfg, peak = derive(cfg0, spec, float(pr_s.length.mean()))
    solid = spec.solid_set()
    print(f"peak {peak} rare {cfg.corr_rare_seed_freq} "
          f"depth_cap {cfg.corr_depth_cap}", flush=True)

    # map each rRNA divergent site to a contig coordinate via its OWN
    # 21-mer (pre-polish contig still carries the variant where assembly
    # used same-copy reads)
    sites = []          # (contig_pos_of_center, own_code, master_code)
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    code = {"A": 0, "C": 1, "G": 2, "T": 3}
    fams = {}
    for c in annot:
        fams.setdefault(c.family, []).append(c)
    for fam, copies in fams.items():
        if not fam.startswith("rrna"):
            continue
        for c in copies:
            for p in c.mut_pos:
                p = int(p)
                if p < 10 or p + 11 > len(genome):
                    continue
                off = (p - c.start) if c.strand == 0 else (c.end - 1 - p)
                votes = []
                for c2 in copies:
                    if c2 is c:
                        continue
                    q = (c2.start + off if c2.strand == 0
                         else c2.end - 1 - off)
                    bb = genome[q]
                    if c2.strand != c.strand:
                        bb = comp[bb]
                    votes.append(bb)
                vals, cnts = np.unique(votes, return_counts=True)
                mb = str(vals[np.argmax(cnts)])
                if mb == genome[p]:
                    continue
                own = genome[p - 10 : p + 11]
                i = contig.find(own)
                strand = 0
                if i < 0:
                    i = contig.find(revcomp_str(own))
                    strand = 1
                    if i < 0:
                        continue
                    if contig.find(revcomp_str(own), i + 1) >= 0:
                        continue
                    sites.append((i + 10, code[comp[genome[p]]],
                                  code[comp[mb]]))
                else:
                    if contig.find(own, i + 1) >= 0:
                        continue
                    sites.append((i + 10, code[genome[p]], code[mb]))
    print(f"{len(sites)} mappable rRNA divergent sites", flush=True)

    MC._DEBUG_SINK = {}
    out = MC.polish_contigs([("contig_0", contig)], pr_s, cfg, solid=solid)
    votes = MC._DEBUG_SINK["votes"]       # (nb, Lpad, N_SYM)
    MC._DEBUG_SINK = None
    own_w = mas_w = flip = keep = 0
    det = []
    for cp, ob, mb in sites:
        v = votes[0, cp]
        if v[ob] >= v[mb]:
            own_w += 1
        else:
            mas_w += 1
        det.append((int(v[ob]), int(v[mb]), int(v.sum())))
    det = np.array(det)
    print(f"votes at sites: own wins {own_w}, master wins {mas_w}")
    if det.size:
        print(f"own votes median {np.median(det[:,0]):.0f}, "
              f"master votes median {np.median(det[:,1]):.0f}, "
              f"depth median {np.median(det[:,2]):.0f}")
    # post-polish: does the polished sequence retain the own variant kmers?
    pol = out[0][1]
    kept = sum(1 for cp, ob, mb in sites
               if "ACGT"[ob] == (pol[cp] if cp < len(pol) else "N"))
    print(f"(approx) polished base equals own at {kept}/{len(sites)} "
          f"sites (coordinate drift makes this a lower bound)")


if __name__ == "__main__":
    main()
