"""Interactive chat REPL of the port (counterpart of
`llm_inference_tpu/cli.py`): a multi-round stdin loop over a ChatSession
with streamed tokens, "exit" to quit and "reset" to clear the history;
without a tokenizer each line runs a fixed prompt and echoes the sampled
ids ("ids> [...]"). Weights come from an HF checkpoint directory, or are
random (dummy) weights of a preset, drawn directly as quantized codes
when --quant is set. --model takes every preset of config.PRESETS (the
llama family on models/llama.py: llama2, llama3, llama3.1, mistral,
qwen2, qwen3, phi3; gemma2 and gemma3 on models/gemma2.py; mixtral-8x7b
on models/mixtral.py; deepseek-v3 and tiny-deepseek on
models/deepseek.py), and --checkpoint an HF directory of any of these
families. Each family's quantize_params and prepare_params shape its
weights (llama's where the module has none).

Usage:
  python -m llm_inference_tpu_torch.cli --model llama2-7b --quant int4 \\
      --group-size 128 --kv-cache int8        # dummy weights, on the card
  python -m llm_inference_tpu_torch.cli --checkpoint /path/to/hf_dir \\
      --tokenizer /path/to/tokenizer.bin --quant int8
  python -m llm_inference_tpu_torch.cli --device cpu --max-seq-len 128
  python -m llm_inference_tpu_torch.cli --model gemma2-2b --quant int8 \
      --kv-cache int8 --max-seq-len 8192      # gemma2 on the card
  python -m llm_inference_tpu_torch.cli --model mixtral-8x7b --quant int4 \
      --group-size 128 --kv-cache int8        # Mixtral-8x7B on the card
  python -m llm_inference_tpu_torch.cli --device cpu --model tiny-deepseek

  python -m llm_inference_tpu_torch.cli --model llama2-7b --tp 2 \
      --quant int4 --group-size 128 --kv-cache int8   # tensor-parallel
  python -m llm_inference_tpu_torch.cli --device cpu --tp 2 --quant int8
  python -m llm_inference_tpu_torch.cli --model llama2-7b --quant int8 \
      --lora sql=/path/to/peft_sql --lora chat=/path/to/peft_chat

--lora NAME=PEFT_DIR (repeatable) loads HF peft adapters
(models/lora.load_peft_adapter) into LoRA stacks served beside the base
model of a llama-family model on one device; the REPL's
"adapter <name|base>" switches adapters and starts a new session.
LLMI_LAYER_MEGA=1 in the environment runs single-sequence decode through
the whole-layer megakernel (models/llama.layer_route). --tp N serves the
model over N tensor-parallel ranks from this one command, as the JAX CLI
does: this process is rank 0 and keeps the REPL, ranks 1..N-1 are spawned
(parallel.run_ranks; NCCL when every rank has a card of its own, else
gloo), each line goes to every rank (broadcast_object), every rank runs
it and rank 0 prints. --asym quantizes the weights with zero points,
--quant int8 --group-size G in groups of G codes, and --no-int4-npair
serves int4 weights on the JAX package's split-half route (the K1 chain
in place of the fused layer kernels; llama-family models, as the JAX CLI
passes it to llama's prepare_params alone). --dp above 1, --lora, --asym,
grouped int8 or --no-int4-npair with --tp above 1, and --tp above 1 on a
mixture-of-experts model (mixtral, DeepSeek: expert parallelism) are not
ported and raise.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch


def build_engine(args, tp=None):
    """The engine the flags describe; with `tp` (a parallel.TPGroup) this
    rank's engine of a tensor-parallel model."""
    from llm_inference_tpu_torch import config as C
    from llm_inference_tpu_torch import resolve_device
    from llm_inference_tpu_torch.engine.engine import InferenceEngine
    from llm_inference_tpu_torch.engine.tokenizer import load_tokenizer
    from llm_inference_tpu_torch.models import get_model, llama
    from llm_inference_tpu_torch.parallel import sharding
    from llm_inference_tpu_torch.utils import checkpoint

    refuse_unported(args)
    device = tp.device if tp is not None else resolve_device(args.device)
    lead = tp is None or tp.rank == 0
    qcfg = C.QuantConfig(weights=args.quant, group_size=args.group_size,
                         asymmetric=args.asym)
    if args.checkpoint:
        cfg, params = checkpoint.load_hf_checkpoint(
            args.checkpoint, dtype=args.dtype, device=device)
    else:
        cfg = C.preset(args.model)
        if args.dtype:
            cfg = dataclasses.replace(cfg, dtype=args.dtype)
        if lead:
            print(f"[cli] no checkpoint given: dummy weights for {cfg.name}")
    model = get_model(cfg.name)
    if args.tp > 1:
        sharding.validate_tp(cfg, args.tp)
    quantize = getattr(model, "quantize_params", llama.quantize_params)
    prepare = getattr(model, "prepare_params", llama.prepare_params)
    quantum = 128 * args.tp
    pad = args.tp > 1 and (cfg.intermediate_size % quantum
                           or cfg.vocab_size % quantum)
    if not args.checkpoint:
        # dummy weights: drawn as codes, or dense where the shards need
        # padding (pad_params_for_tp takes dense weights)
        params = (model.init_params(cfg, seed=0, device=device) if pad
                  else model.init_params_quantized(cfg, qcfg, seed=0,
                                                   device=device))
    if pad or args.checkpoint:
        params = llama.pad_params_for_tp(params, cfg, args.tp)
        params = quantize(params, qcfg, row_shards=args.tp)
    if model is llama:
        # the JAX CLI passes --no-int4-npair to llama's layout pass alone
        params = prepare(params, tp_size=args.tp,
                         int4_npair=args.int4_npair is not False)
    else:
        params = prepare(params, tp_size=args.tp)
    adapter_names = None
    if args.lora:
        # multi-LoRA serving (cli.py:95-126): requests pick adapters by
        # name (generate/ChatSession adapter=, the scheduler, /v1 model)
        from llm_inference_tpu_torch.models import lora
        adapters, scalings, adapter_names = [], [], []
        for spec in args.lora:
            name, _, path = spec.partition("=")
            if not name or not path:
                raise SystemExit(f"--lora expects name=path, got {spec!r}")
            ad, sc = lora.load_peft_adapter(cfg, path)
            adapter_names.append(name)
            adapters.append(ad)
            scalings.append(sc)
        params = dict(params, lora=lora.stack_adapters(
            cfg, adapters, scaling=scalings, device=device))
    tokenizer = load_tokenizer(args.tokenizer) if args.tokenizer else None
    eng_cfg = C.EngineConfig(max_seq_len=args.max_seq_len,
                             decode_chunk=args.decode_chunk)
    cache_dtype = (args.kv_cache if args.kv_cache in ("int8", "int4")
                   else torch.bfloat16)
    return InferenceEngine(cfg, params, engine_cfg=eng_cfg,
                           tokenizer=tokenizer, cache_dtype=cache_dtype,
                           device=device, tp=tp, adapter_names=adapter_names)


def refuse_unported(args) -> None:
    """Raise NotImplementedError for the flags whose machinery the port
    lacks: --dp above 1; --lora, --asym, grouped int8 (--quant int8
    --group-size G) or --no-int4-npair with --tp above 1."""
    tp = args.tp > 1
    for flag, on in (("--dp > 1", args.dp > 1),
                     ("--lora with --tp > 1", bool(args.lora) and tp),
                     ("--asym with --tp > 1", args.asym and tp),
                     ("grouped int8 with --tp > 1",
                      tp and args.quant == "int8" and args.group_size > 0),
                     ("--no-int4-npair with --tp > 1",
                      tp and args.int4_npair is False)):
        if on:
            raise NotImplementedError(f"{flag} is not ported")


def refuse_before_ranks(args) -> None:
    """Raise, before any rank is spawned, where --tp N cannot serve the
    model: LoRA adapters or the weight formats of --asym, grouped int8
    and --no-int4-npair (not ported over TP), a mixture-of-experts family
    (no expert parallelism) or widths that do not split over N
    (parallel.sharding.validate_tp)."""
    import json
    import os
    from llm_inference_tpu_torch import config as C
    from llm_inference_tpu_torch.parallel import sharding
    from llm_inference_tpu_torch.utils import checkpoint
    if (args.lora or args.asym or args.int4_npair is False
            or (args.quant == "int8" and args.group_size > 0)):
        refuse_unported(args)
    if args.checkpoint:
        with open(os.path.join(args.checkpoint, "config.json")) as f:
            cfg = checkpoint.model_config_from_hf(json.load(f))
    else:
        cfg = C.preset(args.model)
    sharding.validate_tp(cfg, args.tp)


def serve(tp, args):
    """The REPL on one rank (tp None: the only one). Rank 0 reads the
    lines and prints; every rank runs each line."""
    from llm_inference_tpu_torch.config import GenerationConfig
    from llm_inference_tpu_torch.engine.engine import ChatSession

    engine = build_engine(args, tp)
    lead = tp is None or tp.rank == 0
    gen = GenerationConfig(max_new_tokens=args.max_new_tokens,
                           temperature=args.temperature, top_k=args.top_k,
                           top_p=args.top_p, min_p=args.min_p,
                           repetition_penalty=args.repetition_penalty,
                           presence_penalty=args.presence_penalty,
                           frequency_penalty=args.frequency_penalty,
                           greedy=args.greedy)
    if lead and engine.tokenizer is None:
        print("[cli] no tokenizer: echoing token ids for dummy runs")
    adapter = None
    session = ChatSession(engine)
    if lead:
        print("Ready. Type your message ('exit' to quit, 'reset' to clear "
              "history" + (", 'adapter <name|base>' to switch LoRA"
                           if engine.adapter_slots else "") + ").")
    while True:
        line = None
        if lead:
            try:
                line = input("you> ").strip()
            except EOFError:
                line = "exit"
        if tp is not None:
            line = tp.broadcast_object(line)
        if not line:
            continue
        if line == "exit":
            break
        if line == "reset":
            session = ChatSession(engine, adapter=adapter)
            continue
        if line == "adapter" or line.startswith("adapter "):
            name = line[len("adapter"):].strip()
            want = None if name in ("", "base") else name
            try:
                engine.resolve_adapter(want)
            except ValueError as e:
                if lead:
                    print(f"[cli] {e}")
                continue
            adapter = want
            # the resident history was written under the old adapter
            session = ChatSession(engine, adapter=adapter)
            if lead:
                print(f"[cli] adapter: {adapter or 'base'} (history reset)")
            continue
        if engine.tokenizer is None:
            # dummy mode: feed fixed ids, print the sampled ids
            res = engine.generate([[1, 2, 3, 4]], gen, adapter=adapter)[0]
            if lead:
                print("ids>", res.token_ids)
            continue
        if lead:
            print("bot> ", end="", flush=True)
        session.ask(line, gen, stream=(lambda s: print(s, end="", flush=True))
                    if lead else None)
        if lead:
            print()
    if lead:
        print("bye.")


def add_engine_args(ap: argparse.ArgumentParser) -> None:
    """The flags build_engine reads (the chat REPL's and the HTTP
    server's)."""
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
                    action="store_false",
                    help="int4 on the split-half route: the K1 chain, no "
                         "fused layer kernels (one device)")
    ap.add_argument("--asym", action="store_true",
                    help="asymmetric (min/max, zero-point) weight "
                         "quantization (one device)")
    ap.add_argument("--kv-cache", default="bf16",
                    choices=["bf16", "int8", "int4"])
    ap.add_argument("--lora", action="append", default=None,
                    metavar="NAME=PEFT_DIR",
                    help="load an HF peft LoRA adapter for multi-LoRA "
                         "serving (repeatable; one device only)")
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--max-seq-len", type=int, default=2048)
    ap.add_argument("--decode-chunk", type=int, default=8)


def main(argv=None):
    ap = argparse.ArgumentParser(description="LLM chat on the PyTorch port")
    add_engine_args(ap)
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
    if args.tp > 1:
        refuse_before_ranks(args)
        from llm_inference_tpu_torch import resolve_device
        from llm_inference_tpu_torch.parallel import run_ranks
        run_ranks(serve, args.tp, args, device=resolve_device(args.device),
                  in_caller=True)
        return
    serve(None, args)


if __name__ == "__main__":
    main()
