"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

Each package holds a wrapper that launches the CUDA kernel (built from
``src/repro_torch/csrc`` by :mod:`repro_torch.kernels._build`) on a CUDA
tensor and runs the plain version, in the same module, on a CPU tensor —
never the plain version on a CUDA tensor.  Every wrapper counts its kernel
launches in a plain integer attribute ``launches``.

  flash_prefill — causal GQA flash attention of a chunk over a kpos cache
                  (restoration recompute step and suffix prefill).
  flash_decode  — one-token GQA attention over a kpos cache.
  kv_restore    — fused dequant-scatter of one restoration load op.
  kv_quant      — per-channel int8 quantize / dequantize of a KV chunk.
"""
