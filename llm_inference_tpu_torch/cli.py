"""Interactive chat REPL of the port (counterpart of
`llm_inference_tpu/cli.py`): a multi-round stdin loop over a ChatSession
with streamed tokens, "exit" to quit and "reset" to clear the history;
without a tokenizer each line runs a fixed prompt and echoes the sampled
ids ("ids> [...]"). Weights come from an HF checkpoint directory, or are
random (dummy) weights of a preset, drawn directly as quantized codes
when --quant is set.

Usage:
  python -m llm_inference_tpu_torch.cli --model llama2-7b --quant int4 \\
      --group-size 128 --kv-cache int8        # dummy weights, on the card
  python -m llm_inference_tpu_torch.cli --checkpoint /path/to/hf_dir \\
      --tokenizer /path/to/tokenizer.bin --quant int8
  python -m llm_inference_tpu_torch.cli --device cpu --max-seq-len 128

LLMI_LAYER_MEGA=1 in the environment runs single-sequence decode through
the whole-layer megakernel (models/llama.layer_route). --tp/--dp above 1,
--lora, --asym and --no-int4-npair are not ported and raise.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch


def build_engine(args):
    from llm_inference_tpu_torch import config as C
    from llm_inference_tpu_torch import resolve_device
    from llm_inference_tpu_torch.engine.engine import InferenceEngine
    from llm_inference_tpu_torch.engine.tokenizer import load_tokenizer
    from llm_inference_tpu_torch.models import llama
    from llm_inference_tpu_torch.utils import checkpoint

    for flag, on in (("--tp > 1", args.tp > 1), ("--dp > 1", args.dp > 1),
                     ("--lora", bool(args.lora)), ("--asym", args.asym),
                     ("--no-int4-npair", args.int4_npair is False)):
        if on:
            raise NotImplementedError(f"{flag} is not ported")
    device = resolve_device(args.device)
    qcfg = C.QuantConfig(weights=args.quant, group_size=args.group_size)
    if args.checkpoint:
        cfg, params = checkpoint.load_hf_checkpoint(
            args.checkpoint, dtype=args.dtype, device=device)
        params = llama.quantize_params(params, qcfg)
    else:
        cfg = C.preset(args.model)
        if args.dtype:
            cfg = dataclasses.replace(cfg, dtype=args.dtype)
        print(f"[cli] no checkpoint given: dummy weights for {cfg.name}")
        params = llama.init_params_quantized(cfg, qcfg, seed=0,
                                             device=device)
    params = llama.prepare_params(params)
    tokenizer = load_tokenizer(args.tokenizer) if args.tokenizer else None
    eng_cfg = C.EngineConfig(max_seq_len=args.max_seq_len,
                             decode_chunk=args.decode_chunk)
    cache_dtype = (args.kv_cache if args.kv_cache in ("int8", "int4")
                   else torch.bfloat16)
    return InferenceEngine(cfg, params, engine_cfg=eng_cfg,
                           tokenizer=tokenizer, cache_dtype=cache_dtype,
                           device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(description="LLM chat on the PyTorch port")
    ap.add_argument("--model", default="tiny")
    ap.add_argument("--checkpoint", default=None,
                    help="HF safetensors directory (else dummy weights)")
    ap.add_argument("--tokenizer", default=None,
                    help="reference .bin vocabulary or tokenizer.json")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--quant", default="none",
                    choices=["none", "int8", "int4"])
    ap.add_argument("--group-size", type=int, default=0)
    ap.add_argument("--int4-npair", action="store_true", default=None,
                    help="accepted for the JAX CLI's sake: the port's int4 "
                         "layout is its only one")
    ap.add_argument("--no-int4-npair", dest="int4_npair",
                    action="store_false", help="not ported")
    ap.add_argument("--asym", action="store_true", help="not ported")
    ap.add_argument("--kv-cache", default="bf16",
                    choices=["bf16", "int8", "int4"])
    ap.add_argument("--lora", action="append", default=None,
                    metavar="NAME=PEFT_DIR", help="not ported")
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--max-seq-len", type=int, default=2048)
    ap.add_argument("--decode-chunk", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--min-p", type=float, default=0.0)
    ap.add_argument("--repetition-penalty", type=float, default=1.0)
    ap.add_argument("--presence-penalty", type=float, default=0.0)
    ap.add_argument("--frequency-penalty", type=float, default=0.0)
    ap.add_argument("--greedy", action="store_true")
    args = ap.parse_args(argv)

    from llm_inference_tpu_torch.config import GenerationConfig
    from llm_inference_tpu_torch.engine.engine import ChatSession

    engine = build_engine(args)
    gen = GenerationConfig(max_new_tokens=args.max_new_tokens,
                           temperature=args.temperature, top_k=args.top_k,
                           top_p=args.top_p, min_p=args.min_p,
                           repetition_penalty=args.repetition_penalty,
                           presence_penalty=args.presence_penalty,
                           frequency_penalty=args.frequency_penalty,
                           greedy=args.greedy)
    if engine.tokenizer is None:
        print("[cli] no tokenizer: echoing token ids for dummy runs")
    session = ChatSession(engine)
    print("Ready. Type your message ('exit' to quit, 'reset' to clear "
          "history).")
    while True:
        try:
            line = input("you> ").strip()
        except EOFError:
            break
        if not line:
            continue
        if line == "exit":
            break
        if line == "reset":
            session = ChatSession(engine)
            continue
        if engine.tokenizer is None:
            # dummy mode: feed fixed ids, print the sampled ids
            res = engine.generate([[1, 2, 3, 4]], gen)[0]
            print("ids>", res.token_ids)
            continue
        print("bot> ", end="", flush=True)
        session.ask(line, gen, stream=lambda s: print(s, end="", flush=True))
        print()
    print("bye.")


if __name__ == "__main__":
    main()
