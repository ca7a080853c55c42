"""Model families of the port (counterpart of `llm_inference_tpu/models/`)."""
