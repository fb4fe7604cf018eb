"""hga_tpu — a device-native hybrid de-novo genome assembler.

A brand-new JAX / XLA / Pallas / pjit framework with the capabilities of the
reference single-node C++ hybrid assembler (matuszelenak/Hybrid-Genome-Assembler):

* k-mer extraction / counting / spectrum analysis over 2-bit-packed read batches
* minimizer seeding + all-vs-all candidate overlap detection
* bit-parallel Myers overlap gating and a banded Smith-Waterman wavefront DP
* overlap-graph construction (CSR tensors), transitive reduction, unitig contigs
* hybrid long-read correction + consensus polishing (pileup DP)
* multi-host data-parallel execution over a `jax.sharding.Mesh` with
  psum / all_gather / all_to_all collectives

Design blueprint: /root/repo/SURVEY.md.  The reference mount was empty during
the survey session, so parity claims are against the judged capability
contract in BASELINE.json rather than file:line citations.
"""

__version__ = "0.1.0"

from hga_tpu.config import AssemblerConfig  # noqa: F401
