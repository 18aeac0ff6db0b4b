"""Serving the transformer LM — KV-cache decode + continuous batching.

Ports examples/serve_lm.py to bigdl_tpu_torch: a decoder-only LM is
trained briefly on a synthetic next-token task, then served through
`InferenceEngine` — ragged prompts, mixed sampling configs (greedy /
temperature / top-k / top-p), per-request max-tokens and stop-ids, all
batched through a fixed set of paged KV-cache slots (the decode step's
attention in the paged-decode kernel on the card). The BigDL-2.0
analog is Cluster Serving (arXiv 2204.01715); here the batching is
continuous (finished sequences evicted and new requests spliced in
between decode steps).

The reliability layer rides along: the engine below runs with a
bounded queue (shed-oldest overload policy), per-request priorities
and deadlines, and a retry budget — and prints `engine.health()` (the
operational snapshot: occupancy, queue composition, p50/p95 decode
latency, reliability counters). Deterministic failure injection for
every path lives in `python -m bigdl_tpu_torch.scripts.fault_drill
--plane serving`. Then a smaller draft model speculates for it, and
the speculative stream is the target-only stream verbatim.

    python -m bigdl_tpu_torch.examples.serve_lm [--device cpu]
"""

import argparse
import time

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.dataset.text import synthetic_next_token
from bigdl_tpu_torch.models import transformer
from bigdl_tpu_torch.optim import Adam, Optimizer, Trigger
from bigdl_tpu_torch.serving import InferenceEngine, Request
from bigdl_tpu_torch.utils.device import resolve_device

# graftlint: disable-file=telemetry-bypass — a CLI owns its stdout

VOCAB, SEQ = 64, 64


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = resolve_device(ap.parse_args(argv).device)
    # 1. train a small LM so generations aren't pure noise
    model = transformer.build_lm(VOCAB, dim=64, num_heads=4,
                                 num_layers=2, max_len=SEQ, device=device)
    model.build(torch.Generator().manual_seed(0))
    samples = synthetic_next_token(256, VOCAB, 32)
    (Optimizer(model, DataSet.array(samples), nn.ChunkedSoftmaxCE(),
               batch_size=32)
     .set_optim_method(Adam(learningrate=3e-3))
     .set_end_when(Trigger.max_epoch(3))
     .optimize())

    # 2. serve it: 4 cache slots, two prefill buckets, bounded queue
    # with shed-oldest overload policy and a 1-retry step budget
    engine = InferenceEngine(model, slots=4, prefill_buckets=(8, 16),
                             max_queue=8, overload_policy="shed-oldest",
                             step_retries=1, device=device)
    requests = [
        Request(prompt=[1, 2, 3], max_new_tokens=12),            # greedy
        Request(prompt=list(range(2, 16)), max_new_tokens=12,
                temperature=0.8, top_k=8, seed=1),
        Request(prompt=[5, 6, 7, 8], max_new_tokens=12,
                temperature=1.0, top_p=0.9, seed=2),
        Request(prompt=[9, 10], max_new_tokens=24, stop_ids=(0,),
                temperature=0.7, seed=3, priority=5),  # jumps the queue
        Request(prompt=list(range(1, 10)), max_new_tokens=12,
                deadline_s=300.0),                     # generous TTL
        Request(prompt=[4] * 7, max_new_tokens=12, temperature=0.9,
                seed=4),
    ]
    t0 = time.perf_counter()
    results = engine.run(requests)
    dt = time.perf_counter() - t0

    total = 0
    for r in results:
        total += len(r.tokens)
        print(f"req {r.id}: prompt[:6]={r.prompt[:6]} -> "
              f"{r.tokens} ({r.status}/{r.finish_reason})")
    print(f"\n{total} tokens across {len(results)} requests in "
          f"{dt:.2f}s")
    print(f"engine stats: {engine.stats}")
    print(f"engine health: {engine.health()}")
    assert all(r.status == "done" for r in results)
    assert engine.health()["state"] == "ok"

    # 3. speculative decoding: a SMALLER model trained on the same task
    # drafts k tokens ahead, the big model verifies all of them in ONE
    # batched pass, and coupled acceptance keeps the output stream
    # bitwise the target-only stream — both models learned the task, so
    # they agree often and most rounds emit several tokens per target
    # weight pass
    from bigdl_tpu_torch.serving import SpeculativeEngine

    draft_model = transformer.build_lm(VOCAB, dim=32, num_heads=2,
                                       num_layers=2, max_len=SEQ,
                                       device=device)
    draft_model.build(torch.Generator().manual_seed(0))
    (Optimizer(draft_model, DataSet.array(samples),
               nn.ChunkedSoftmaxCE(), batch_size=32)
     .set_optim_method(Adam(learningrate=3e-3))
     .set_end_when(Trigger.max_epoch(3))
     .optimize())
    spec = SpeculativeEngine(
        InferenceEngine(draft_model, slots=4, prefill_buckets=(8, 16),
                        device=device),
        InferenceEngine(model, slots=4, prefill_buckets=(8, 16),
                        device=device),
        k=4)
    respec = spec.run([Request(prompt=list(r.prompt),
                               max_new_tokens=12, seed=7)
                       for r in results[:4]])
    ref = InferenceEngine(model, slots=4, prefill_buckets=(8, 16),
                          device=device).run(
        [Request(prompt=list(r.prompt), max_new_tokens=12, seed=7)
         for r in results[:4]])
    assert [r.tokens for r in respec] == [r.tokens for r in ref], \
        "speculative output must be the target-only stream verbatim"
    h = spec.health()["speculative"]
    print(f"\nspeculative decode: accept rate {h['accept_rate']}, "
          f"{h['tokens_per_round']} tokens/verify-round "
          f"(k={h['k']}, draft {sum(len(r.tokens) for r in respec)} "
          f"tokens bit-identical to target-only)")
    return results


if __name__ == "__main__":
    main()
