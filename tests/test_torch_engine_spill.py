"""The port's host-RAM spill tier and tree migration
(bigdl_tpu_torch/serving/engine.py: `spill`, `host_blocks`, spill and
re-admission, `export_tree` / `import_tree`, `prefix_match_tokens`)
against the JAX package's InferenceEngine on the scenarios of
tests/test_kv_pool.py's TestSpillTier, on the CPU, at the tiny size of
tests/test_torch_engine_lifecycle.py.

Across the frameworks, greedy tokens and the kv_spill_blocks /
kv_readmit_blocks / kv_host_evictions / prefix_hits counters must be
EQUAL. Inside the port, spilled blocks are bytes: a warm run after a
spill and re-admission must equal the cold run bit for bit (sampled
tokens, so every logit bit counts), and a re-admitted block must hold
exactly the bits it held before it spilled — in fp32 and in bf16."""

import numpy as np
import pytest
import torch

import test_torch_engine_lifecycle as lc

models = lc.models
# one slot, a 20-token cache and 5 usable blocks: a 13-token prompt holds
# 4, so its cached 3-block chain must spill to admit another such prompt
SPILL = dict(slots=1, prefill_buckets=(8, 16), block_size=4, max_len=20,
             pool_blocks=6)
P = [5, 9, 3, 7, 2, 8, 4, 6, 1, 3, 9, 2, 7]
F = [30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42]
G = [50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 1, 2]
COUNTERS = ("kv_spill_blocks", "kv_readmit_blocks", "kv_host_evictions",
            "prefix_hits", "pool_evictions", "prefill_calls")


def _tree_ops(kv_pool, prefix_cache):
    """The host-tier tree operations of tests/test_kv_pool.py's
    TestSpillTier units through one package's BlockPool and
    RadixPrefixCache; returns everything they report."""
    def chain(pool, tree, tokens):
        blocks = pool.alloc(len(tokens) // pool.block_size)
        for b in tree.insert(tokens, blocks):
            pool.mark_cached(b)
        pool.unref(blocks)
        return blocks

    out = []
    pool = kv_pool.BlockPool(32, 4)
    tree = prefix_cache.RadixPrefixCache(pool, host_blocks=8)
    toks = list(range(1, 9))
    a = chain(pool, tree, toks)
    b = chain(pool, tree, [20, 21, 22, 23])
    tree.lookup(toks, 2)                         # touch chain a
    out.append([n.block for n in tree.spill_victims(3)])
    pool.ref([a[0]])                             # a user pins it
    out.append([n.block for n in tree.spill_victims(3)])
    pool.unref([a[0]])
    prot = frozenset(tree.lookup_nodes(toks, 2))
    out.append([n.block for n in tree.spill_victims(3, prot)])
    node = tree.spill_victims(1)[0]
    out.append((node.block, tree.park(node, "BYTES"), pool.free_count,
                tree.num_blocks, tree.host_in_use, tree.lookup(toks, 2),
                len(tree.lookup_nodes(toks, 2)), tree.peek_blocks(toks, 2)))
    nb = pool.alloc(1)[0]
    out.append(tree.readmit(node, nb))
    pool.mark_cached(nb)
    pool.unref([nb])
    out.append((tree.lookup(toks, 2), tree.host_in_use, b))
    for n in tree.spill_victims(3):
        tree.park(n, bytes(n.tokens))
    out.append([tree.evict_host_one() for _ in range(4)])
    t2 = prefix_cache.RadixPrefixCache(kv_pool.BlockPool(8, 4),
                                       host_blocks=2)
    out.append([t2.graft_host(toks[:4], "D0"), t2.graft_host(toks, "D1"),
                t2.graft_host([70, 71, 72, 73, 80, 81, 82, 83], "ORPHAN"),
                t2.graft_host(toks[:4], "X"),
                t2.graft_host([90, 91, 92, 93], "D2"), t2.host_in_use,
                t2.peek_blocks(toks, 2)])
    out.append(prefix_cache.RadixPrefixCache(
        kv_pool.BlockPool(8, 4)).graft_host(toks[:4], "D0"))
    return out


def test_tree_host_tier_like_jax():
    from bigdl_tpu.serving import kv_pool as jpool
    from bigdl_tpu.serving import prefix_cache as jtree
    from bigdl_tpu_torch.serving import kv_pool as tpool
    from bigdl_tpu_torch.serving import prefix_cache as ttree

    got, ref = _tree_ops(tpool, ttree), _tree_ops(jpool, jtree)
    assert got == ref
    assert got[0][0] == got[5][2][0]             # chain b spills first
    assert got[7][:2] == [True, True] and got[8] is False


def _req(s, prompt, **kw):
    return s.m.Request(prompt=list(prompt), max_new_tokens=3, **kw)


@pytest.mark.parametrize("host_blocks", [8, 3, None],
                         ids=["tier", "host_evictions", "no_spill"])
def test_spill_waves_equal_jax(models, host_blocks):
    """P, F, G, P, F through one engine: every wave after the first
    spills an older prompt's chain (or, with the tier off, evicts it)
    and the repeats re-admit their own; a 3-block host tier also evicts
    to oblivion (only childless host nodes can go)."""
    kw = dict(SPILL) if host_blocks is None \
        else dict(SPILL, spill=True, host_blocks=host_blocks)
    out = []
    for s in lc.sides(models):
        eng = s.engine(**kw)
        toks = [eng.run([_req(s, p)])[0].tokens for p in (P, F, G, P, F)]
        out.append((toks, [eng.stats[k] for k in COUNTERS],
                    eng.health()["prefix"]["host_in_use"]))
    assert out[1] == out[0]
    spilled, readmitted, host_evicted = out[1][1][:3]
    if host_blocks is None:
        assert spilled == readmitted == 0
    else:
        assert spilled > 0 and readmitted > 0
        assert host_evicted > 0 or host_blocks == 8


def test_spill_round_trip_is_bitwise(models):
    """Warm after spill + re-admission == cold == the first run, sampled
    tokens and all."""
    _, pt = lc.sides(models)
    kw = dict(temperature=0.8, seed=11)
    cold = pt.engine(prefix_cache=False, **SPILL).run(
        [_req(pt, P, **kw)])[0]
    eng = pt.engine(spill=True, host_blocks=8, **SPILL)
    first = eng.run([_req(pt, P, **kw)])[0]
    eng.run([_req(pt, F, temperature=0.8, seed=2)])
    assert eng.stats["kv_spill_blocks"] >= 1
    assert eng.health()["prefix"]["host_in_use"] >= 1
    warm = eng.run([_req(pt, P, **kw)])[0]
    assert eng.stats["kv_readmit_blocks"] >= 1
    assert eng.stats["prefix_hits"] >= 1
    assert warm.tokens == cold.tokens == first.tokens


def _chain_bits(eng, prompt):
    """The bits of `prompt`'s cached chain, whichever tier holds it."""
    out = []
    for node in eng._prefix._walk(prompt, (len(prompt) - 1) // 4):
        if node.block is None:
            out.append(np.stack([np.stack([lay["k"], lay["v"]])
                                 for lay in node.host]))
        else:
            out.append(np.stack([np.stack(
                [lay[k][node.block].view(torch.int16).numpy()
                 if lay[k].dtype == torch.bfloat16
                 else lay[k][node.block].numpy() for k in ("k", "v")])
                for lay in eng.pool]))
    return out


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
def test_readmitted_blocks_hold_their_bits(models, cache_dtype):
    _, pt = lc.sides(models)
    eng = pt.engine(spill=True, host_blocks=8, cache_dtype=cache_dtype,
                    **SPILL)
    eng.run([_req(pt, P)])
    before = _chain_bits(eng, P)
    eng.run([_req(pt, F)])                   # P's chain spills
    spilled = eng._prefix.host_in_use
    assert spilled >= 1
    parked = _chain_bits(eng, P)
    eng.run([_req(pt, P)])                   # and comes back
    assert eng.stats["kv_readmit_blocks"] == spilled
    after = _chain_bits(eng, P)
    for a, b, c in zip(before, parked, after):
        assert a.dtype == b.dtype == c.dtype
        assert a.tobytes() == b.tobytes() == c.tobytes()


def test_export_import_tree(models):
    """A drained engine's tree, exported and imported into a fresh
    spill engine, gives prefix hits on the next wave (through
    re-admission) with the cold run's tokens; a JAX engine's export
    imports into the port too."""
    jx, pt = lc.sides(models)
    prompts = [P, P[:9] + [20, 21, 22, 23], F]
    cold = [pt.engine(prefix_cache=False, **SPILL).run(
        [_req(pt, p)])[0].tokens for p in prompts]
    for src in (pt, jx):
        old = src.engine(**SPILL)
        for p in prompts[:2]:
            old.run([_req(src, p)])
        entries = old.export_tree()
        assert [len(e["tokens"]) for e in entries] == [4, 8, 12, 12]
        new = pt.engine(spill=True, host_blocks=8, **SPILL)
        assert new.import_tree(entries) == 4
        assert new.prefix_match_tokens(P) == 12
        toks = [new.run([_req(pt, p)])[0].tokens for p in prompts]
        assert toks == cold
        assert new.stats["prefix_hits"] == 2
        assert new.stats["kv_readmit_blocks"] >= 3
    bad = [{"tokens": e["tokens"], "kv": e["kv"][:1]} for e in entries]
    with pytest.raises(ValueError, match="same-layout"):
        new.import_tree(bad)
    assert pt.engine(**SPILL).import_tree(entries) == 0   # no host tier


def test_spill_knob_validation_like_jax(models):
    for s in lc.sides(models):
        for kw, match in ((dict(spill=True, prefix_cache=False),
                           "prefix_cache"),
                          (dict(host_blocks=4), "host_blocks"),
                          (dict(spill=True, host_blocks=0), "host_blocks"),
                          (dict(admit_requeue_budget=0),
                           "admit_requeue_budget")):
            with pytest.raises(ValueError, match=match):
                s.engine(**dict(SPILL, **kw))
