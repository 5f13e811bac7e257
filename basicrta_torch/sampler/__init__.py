"""The Gibbs sampler: fused sweep kernels, buckets and the per-residue API."""
