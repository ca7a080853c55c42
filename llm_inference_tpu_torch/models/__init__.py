"""Model families of the port (counterpart of `llm_inference_tpu/models/`):
llama (and the families that differ from it by config), gemma2/gemma3,
mixtral and DeepSeek-V3, each registered by name with `registry`."""

from llm_inference_tpu_torch.models import llama  # noqa: F401
from llm_inference_tpu_torch.models import gemma2  # noqa: F401
from llm_inference_tpu_torch.models import mixtral  # noqa: F401
from llm_inference_tpu_torch.models import deepseek  # noqa: F401
from llm_inference_tpu_torch.models.registry import (get_model,  # noqa: F401
                                                     register_model)
