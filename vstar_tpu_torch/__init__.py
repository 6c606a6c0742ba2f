"""vstar_tpu_torch: the PyTorch / CUDA port of vstar_tpu for NVIDIA Hopper.

The JAX package `vstar_tpu` is the reference. This package mirrors its
sub-packages and module names, keeps its layouts at public functions
(dense weights (in, out), activations [B, S, H, D], images NHWC, KV
cache [L, B, S_max, H_kv, Dh]) and keeps its own copies of the JAX
package's host modules (configs, tokenizers, conversation templates, host
preprocessing, the search policy, SEAL host helpers): it imports neither
`jax` nor `vstar_tpu`. Every Pallas kernel on the ported path is a
hand-written CUDA kernel for sm_90a under `csrc/`.
"""
