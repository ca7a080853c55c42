"""Hand-written CUDA kernels of the port (counterpart of
`llm_inference_tpu/ops/pallas/`). Each module holds a kernel's launch
wrapper, its plain PyTorch version and a `launches` counter:

- quant_matmul.py     — K1 fused-norm GEMV/GEMM, K8 tiled prefill GEMM, K6
                        layer tail (csrc/quant_matmul*.cu, layer_tail.cu
                        on the weight ring of weight_ring.cuh)
- decode_attention.py — K2/K5 decode attention (csrc/decode_attention.cu,
                        its tile walk in decode_tile.cuh)
- flash_attention.py  — K9 flash prefill attention (csrc/flash_attention.cu)
- paged_attention.py, paged_flash.py — K10a/K10b, K11 over a paged pool
- kv_write.py         — K3/K4 decode KV writes, the int4 scale write and
                        the row writes after K12 (csrc/kv_write.cu)
- layer_fused.py      — K12, a whole decode layer at B = 1
                        (csrc/layer_fused.cu: K6's weight ring and K2's
                        tile walk)

`_build.py` compiles `csrc/` at first use. Importing this package builds
nothing.
"""
