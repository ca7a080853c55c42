"""Tensor operations of the port (counterpart of `llm_inference_tpu/ops/`)."""
