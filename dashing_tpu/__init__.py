"""dashing_tpu — an accelerator-native genomic sketching framework.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of dnbaker/dashing
(reference mounted at /root/reference): k-mer sketching of FASTA/FASTQ into
probabilistic set summaries (HyperLogLog and friends) and massively parallel
pairwise similarity/distance matrices (Jaccard, Mash, containment).

Design stance (not a port):
  * The reference streams bases through callbacks (`for_each(λ kmer: h.addh(kmer))`,
    reference src/sketch_and_cmp.h:180-206).  We invert that into array programs:
    fixed-width base tiles with (k-1) halos -> vectorized shift-or k-mer encoding
    -> vectorized 64-bit hashing (as uint32 pairs)
    -> register max-reduction.
  * Pairwise comparison (reference src/sketch_and_cmp.h:699-710 `perform_core_op`,
    an OpenMP loop of scalar estimator calls) becomes batched int8 indicator
    matmuls: for HLL registers a,b the joint statistics the Ertl estimators
    need are all of the form sum_r f(a_r) * g(b_r), i.e. dot products.
  * Sketch union (reference src/union.cpp:11-24 log2-depth OpenMP merge tree)
    becomes an elementwise-max all-reduce over a jax.sharding.Mesh.

Package layout:
  u64        -- uint64 arithmetic emulated on uint32 pairs (device friendly)
  hashes     -- WangHash and seeded variants
  ops        -- device compute: encoders, HLL register updates, pairwise stats
  sketch     -- sketch data structures + estimators (HLL first; khset oracle...)
  io         -- host-side FASTA/FASTQ parsing, sketch/matrix file formats
  parallel   -- mesh sharding: data-parallel sketching, sharded all-pairs
  cli        -- the `dashing_tpu` command surface mirroring the reference CLI
"""

__version__ = "0.1.0"
