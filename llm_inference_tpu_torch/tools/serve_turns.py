"""Time the continuous-batching schedulers of this tree against another
tree's (the parent's), in turns.

    python -m llm_inference_tpu_torch.tools.serve_turns --baseline DIR

DIR holds the other tree's `llm_inference_tpu_torch` (a `git archive` of
it, kernels and all). Each turn is a fresh process that imports one
tree's package, builds LLaMA-2-7B int4 g=128 (random, seed 0) and serves
16 distinct 128-token prompts of 64 greedy tokens with top-2 logprobs
through ContinuousBatchingScheduler over a dense int8 cache of 8 slots x
512 and through PagedScheduler over int8 pages of 128, after a warm-up;
three timed runs each. The turns go baseline, this tree, this tree,
baseline, baseline, this tree. Each prints one JSON line: the tree, the
tokens/s of every run, and a digest of the tokens (equal trees give
equal digests). Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve()
TREE = HERE.parents[2]
ORDER = ("baseline", "change", "change", "baseline", "baseline", "change")


def one_turn(label: str, tree: str, model: str, device: str) -> None:
    """Serve the requests through `tree`'s package; print one JSON
    line."""
    sys.path.insert(0, tree)
    import torch
    import llm_inference_tpu_torch
    from llm_inference_tpu_torch import config
    from llm_inference_tpu_torch.engine import scheduler
    from llm_inference_tpu_torch.engine.engine import InferenceEngine
    from llm_inference_tpu_torch.models import llama

    if not llm_inference_tpu_torch.__file__.startswith(tree):
        raise RuntimeError(f"{label}: imported {llm_inference_tpu_torch}")
    cfg = config.preset(model)
    params = llama.prepare_params(llama.init_params_quantized(
        cfg, config.QuantConfig(weights="int4", group_size=128,
                                quantize_embedding=True),
        seed=0, device=device))
    g = torch.Generator().manual_seed(5)
    prompts = [torch.randint(1, cfg.vocab_size, (128,),
                             generator=g).tolist() for _ in range(16)]
    gen = config.GenerationConfig(greedy=True, max_new_tokens=64,
                                  eos_token_ids=())
    out = {"tree": label}
    for name, seq in (("dense", 512), ("paged", 4096)):
        eng = InferenceEngine(cfg, params, engine_cfg=config.EngineConfig(
            max_seq_len=seq, max_batch_size=8, page_size=128),
            cache_dtype="int8", device=device)

        def make():
            return (scheduler.ContinuousBatchingScheduler(eng, gen)
                    if name == "dense"
                    else scheduler.PagedScheduler(eng, gen))
        make().run(prompts[:3], max_new_tokens=8)          # warm-up
        rates, toks = [], None
        for _ in range(3):
            s = make()
            if device != "cpu":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            reqs = [s.submit(p, 64, top_logprobs=2) for p in prompts]
            while s.step():
                pass
            if device != "cpu":
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            rates.append(round(sum(len(r.output_ids) for r in reqs) / dt, 1))
            toks = [r.output_ids for r in reqs]
        out[name] = rates
        out[name + "_tokens"] = hashlib.md5(
            str(toks).encode()).hexdigest()[:12]
        del eng
    print(json.dumps(out), flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", required=True,
                    help="the other tree (its llm_inference_tpu_torch)")
    ap.add_argument("--model", default="llama2-7b")
    ap.add_argument("--device", default="cuda")
    # one turn, in a process of its own: the tree whose package it runs
    ap.add_argument("--turn", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--tree", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.turn is not None:
        one_turn(args.turn, args.tree, args.model, args.device)
        return
    if args.device != "cpu":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    trees = {"baseline": str(Path(args.baseline).resolve()),
             "change": str(TREE)}
    for label in ORDER:
        subprocess.run([sys.executable, str(HERE), "--baseline",
                        args.baseline, "--model", args.model, "--device",
                        args.device, "--turn", label, "--tree",
                        trees[label]], check=True, cwd=trees[label])


if __name__ == "__main__":
    main()
