"""Hand-written CUDA kernels of the port (counterpart of
`llm_inference_tpu/ops/pallas/`). Each module holds a kernel's launch
wrapper, its plain PyTorch version and a `launches` counter:

- quant_matmul.py     — K1, int8 fused-norm GEMV/GEMM (csrc/quant_matmul.cu)
- decode_attention.py — K2, decode attention (csrc/decode_attention.cu)
- kv_write.py         — K3, decode KV write (csrc/kv_write.cu)

`_build.py` compiles `csrc/` at first use. Importing this package builds
nothing.
"""
