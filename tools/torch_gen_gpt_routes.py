"""Why two routes of one int8 ClipGPT pick different greedy tokens on the card.

Runs on a CUDA card: ``python tools/torch_gen_gpt_routes.py [--out FILE]``
(about four minutes on an H100). It builds ClipGPT on gpt2-large from seed 0 as
``chip_smoke.py`` does, quantises it to the int8 tree and reads:

``layers``
    One decode step through the kernel route (K7, ``streamed_qmatmul``) and
    through the plain route (``SUMMER_CLIP_GEMV=0``) from the same prefilled
    cache. For every block: max |d| of the block's output with each route fed
    its own earlier output (free running), the number of inputs of the block's
    first product whose bf16 rounding differs between the routes, and max |d|
    of the block alone when both routes get the plain route's input (layer
    local). A kernel that is right stays at the f32 sum-order level layer
    locally; the free-running gap grows where roundings flip.
``greedy``
    For each of a few model seeds, greedy ids of the three prompts: solo and
    batched, through K7, through the megakernel (K8 over int8 rings), through the
    plain route, and through the plain route with every matrix product and
    softmax summed in f64 (the same functions, no last-bit differences from the
    order of f32 sums). Left padding and ``key_pad`` are right if batched rows
    equal solo runs once the order of the sums is out of the picture.
``readings``
    What ``chip_smoke.py`` gates on, for the K7 routes and for a planted fault
    (one 128-column tile of one block's ``c_proj`` scaled by zero, as a column
    tile that was never reduced would read): a route's picks held teacher
    forced against the plain route's logits, as the share of the row's logit
    spread (best minus mean) by which a pick misses the plain route's best; and
    max |d| of the route's own teacher-forced logits against the plain
    route's, as a share of the same spread. The same for the megakernel route,
    whose int8 rings move its logits for a reason that is no fault, and for the
    same fault planted into K8's packed parameters.
``k8_block``
    What ``chip_smoke.py`` gates K8 on block by block: max |d| over max |y| of
    one block against the plain version on equal inputs, for each block of the
    model, and for the faulted block with the fault planted.
``host``
    Wall clock of a decode step in the host loop and in the device loop.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

MODEL_CFG = {"gpt_config": "gpt2-large", "clip_emb_dim": 512,
             "adapters": {"emb_hid_dim": 1024, "head_hid_dim": 1024}}
PROMPTS = ("a photo of a", "a dog", "this is a picture of")
NEW_TOKENS = 20
FAULT_BLOCK, FAULT_COLS = 17, slice(128, 256)
DEVICE = "cuda"   # --device cpu with --config test-gpt-mega is a dry run of the script


@contextlib.contextmanager
def env(**kv):
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in old.items():
            os.environ.pop(k, None) if v is None else os.environ.__setitem__(k, v)


@contextlib.contextmanager
def sums_in_f64():
    """Every f32 ``torch.matmul`` and ``torch.softmax`` computed in f64 and
    rounded once: the plain route's functions without its sum order."""
    import torch

    matmul, softmax = torch.matmul, torch.softmax

    def matmul64(a, b):
        if a.dtype == torch.float32 and b.dtype == torch.float32:
            return matmul(a.double(), b.double()).float()
        return matmul(a, b)

    def softmax64(x, dim=-1):
        return softmax(x.double(), dim=dim).to(x.dtype)

    torch.matmul, torch.softmax = matmul64, softmax64
    try:
        with env(SUMMER_CLIP_GEMV="0"):
            yield
    finally:
        torch.matmul, torch.softmax = matmul, softmax


def layer_probe(qmodel, ids):
    """One decode step (the last id of ``ids`` after a prefill of the rest),
    block by block, K7 route against plain route."""
    import torch

    from summer_clip_torch.models import gpt2 as gpt2_mod

    n = len(ids) - 1
    blocks = [getattr(qmodel.core, f"h_{i}") for i in range(qmodel.config.n_layer)]
    with torch.inference_mode():
        prompt = torch.tensor([ids[:n]], device=DEVICE)
        cache = qmodel(prompt, position_offset=0, cache=qmodel.init_cache(1, n + 1),
                       compute_logits=False)["cache"]       # wide route: the same for both

        def copy(c):
            return [{"k": x["k"].clone(), "v": x["v"].clone(), "index": n} for x in c]

        seen = {}

        def run(route):
            seen[route] = []
            hooks = [b.register_forward_hook(
                lambda m, args, out, route=route: seen[route].append((args[0].clone(), out[0].clone())))
                for b in blocks]
            try:
                qmodel(torch.tensor([[ids[n]]], device=DEVICE), position_offset=n, cache=copy(cache),
                       compute_logits=False)
            finally:
                for h in hooks:
                    h.remove()

        run("k7")
        with env(SUMMER_CLIP_GEMV="0"):
            run("plain")
        mask = gpt2_mod.cache_mask(n, 1, n + 1, None, DEVICE)
        rows = []
        for i, block in enumerate(blocks):
            (xa, ya), (xb, yb) = seen["k7"][i], seen["plain"][i]
            flips = int((block.ln_1(xa).bfloat16() != block.ln_1(xb).bfloat16()).sum())
            local, _ = block(xb, copy(cache)[i], mask)          # K7 on the plain route's input
            rows.append({"block": i, "free_running_max_abs_d": float((ya - yb).abs().max()),
                         "input_roundings_that_differ": flips,
                         "layer_local_max_abs_d": float((local - yb).abs().max()),
                         "output_abs_max": float(yb.abs().max())})
    return rows


def forced_logits(qmodel, table, ids, n_prompt, solo_steps):
    """Logits of every generated position of ``ids``, teacher forced: in one
    wide forward (more than 8 rows: the plain versions), or with
    ``solo_steps`` token by token through the cache, as the device loop runs
    (one row: K7 unless the environment says otherwise), or with
    ``solo_steps="mega"`` through the megakernel route (wide prefill, the cache
    as int8 rings, K8 a token; packed after any fault was planted)."""
    import torch

    from summer_clip_torch.apps.gen_gpt import _mega_state
    from summer_clip_torch.models.gpt2 import decode_inputs
    from summer_clip_torch.ops import decode_block as DB
    from summer_clip_torch.ops import gemv

    with torch.inference_mode():
        if not solo_steps:
            hidden = qmodel(torch.tensor([ids[:-1]], device=DEVICE),
                            compute_logits=False)["hidden"][0, n_prompt - 1:]
            return gemv.matmul_reference(hidden, table.q, table.scale)
        cache = qmodel.init_cache(1, len(ids))
        out = qmodel(torch.tensor([ids[:n_prompt]], device=DEVICE), position_offset=0, cache=cache,
                     compute_logits=False)
        rows = [gemv.qdot(out["hidden"][:, -1, :], table, torch.float32)[0]]
        if solo_steps == "mega":
            packed, head = _mega_state(qmodel, "forced_logits")
            kv = DB.cache_to_mega(out["cache"], len(ids), torch.int8)
            for pos in range(n_prompt, len(ids) - 1):
                offset = torch.full((1,), pos, dtype=torch.long, device=DEVICE)
                x = decode_inputs(qmodel, torch.tensor([ids[pos]], device=DEVICE), offset)
                y, *fresh = DB.decode_block(x, packed, kv, offset, nh=qmodel.config.n_head)
                DB.mega_update_kv(kv, *fresh, offset)
                rows.append(head(y)[0])
            return torch.stack(rows)
        for pos in range(n_prompt, len(ids) - 1):
            out = qmodel(torch.tensor([[ids[pos]]], device=DEVICE), position_offset=pos,
                         cache=out["cache"], compute_logits=False)
            rows.append(gemv.qdot(out["hidden"][:, -1, :], table, torch.float32)[0])
        return torch.stack(rows)


def k8_block_gate(qmodel, fault, fault_block: int) -> dict:
    """max |d| / max |y| of K8 against the plain version, one block at a time
    on the plain version's input (one stream, a ring of 256 rows filled to 179),
    without and with the fault planted into the packed parameters."""
    import torch

    from summer_clip_torch.ops import decode_block as DB

    cfg = qmodel.config
    good = DB.pack_core_params(qmodel.tree()["core"], cfg.n_layer, store="int8")
    with fault():
        bad = DB.pack_core_params(qmodel.tree()["core"], cfg.n_layer, store="int8")
    g = torch.Generator(device=DEVICE).manual_seed(0)
    idx = torch.tensor([179], dtype=torch.int32, device=DEVICE)
    x = torch.randn((1, cfg.n_embd), device=DEVICE, generator=g)
    rel, rel_fault = [], None
    for lay in range(cfg.n_layer):
        rows = torch.randn((2, 1, 1, 256, cfg.n_embd), device=DEVICE, generator=g)
        k, ks = DB._quant_rows(rows[0], torch.int8)
        v, vs = DB._quant_rows(rows[1] * 0.5, torch.int8)
        kv = {"k": k, "v": v, "ks": ks, "vs": vs}
        one = {key: val[lay:lay + 1] for key, val in good.items()}
        want = DB.decode_block_reference(x, one, kv, idx, nh=cfg.n_head)
        got = DB.decode_block(x, one, kv, idx, nh=cfg.n_head)
        rel.append(float((got[0] - want[0]).abs().max() / want[0].abs().max()))
        if lay == fault_block:
            broken = DB.decode_block(x, {key: val[lay:lay + 1] for key, val in bad.items()}, kv, idx,
                                     nh=cfg.n_head)
            rel_fault = float((broken[0] - want[0]).abs().max() / want[0].abs().max())
        x = want[0]
    return {"block_rel_max": max(rel), "block_rel_of_the_faulted_block": rel[fault_block],
            "with_the_fault_planted": rel_fault}


def reading(qmodel, table, ids, n_prompt, fault=None, steps=True):
    """(pick share, logit share) of one generated sequence; ``fault`` is a
    context manager that plants a fault into the route walked (``steps``: True
    for K7's, "mega" for the megakernel's)."""
    import torch

    plain = forced_logits(qmodel, table, ids, n_prompt, solo_steps=False)
    with (fault() if fault else contextlib.nullcontext()):
        own = forced_logits(qmodel, table, ids, n_prompt, solo_steps=steps)
    picked = plain.gather(-1, torch.tensor(ids[n_prompt:], device=DEVICE)[:, None])[:, 0]
    best = plain.max(-1).values
    spread = best - plain.mean(-1)
    centred = (own - own.mean(-1, keepdim=True)) - (plain - plain.mean(-1, keepdim=True))
    return (float(((best - picked) / spread).max()),
            float((centred.abs().amax(-1) / spread).max()))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="outputs/gen_gpt_routes.json")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--config", default="gpt2-large")
    ap.add_argument("--seeds", default="0,1,2,3,4,5,6,7",
                    help="model seeds for the greedy part; the other parts use the first")
    args = ap.parse_args()
    global DEVICE
    DEVICE = args.device
    if DEVICE == "cuda" and not torch.cuda.is_available():
        print("this tool runs only on a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = "none (a dry run on the CPU)"
    if DEVICE == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)

    from summer_clip_torch.apps import gen_gpt
    from summer_clip_torch.engine.quant import quant_head_table, quantize_tree
    from summer_clip_torch.models.tokenizer import get_tokenizer

    tok = get_tokenizer()
    prompts = [[tok.sot_token] + tok.encode(p) for p in PROMPTS]
    kw = dict(max_new_tokens=NEW_TOKENS, top_k=1, quant_int8=True)

    def same(a, b):
        return f"{sum(x == y for p, q in zip(a, b) for x, y in zip(p, q))} of {sum(map(len, a))}"

    out = {"card": card, "greedy": {}}
    for seed in reversed([int(x) for x in args.seeds.split(",")]):   # the first seed's model stays
        model = gen_gpt.build_clip_gpt(dict(MODEL_CFG, gpt_config=args.config), tok.vocab_size,
                                       seed, DEVICE)
        qmodel = model.with_tree(quantize_tree(model.tree())).eval()
        del model

        def solo():
            return [gen_gpt.generate_device(qmodel, p, **kw) for p in prompts]

        def batched():
            return gen_gpt.generate_device_batched(qmodel, prompts, **kw)

        ids = {"k7 solo": solo(), "k7 batched": batched()}
        kw["megakernel"] = True
        ids["k8 solo"], ids["k8 batched"] = solo(), batched()
        del kw["megakernel"]
        with env(SUMMER_CLIP_GEMV="0"):
            ids["plain solo"], ids["plain batched"] = solo(), batched()
        with sums_in_f64():
            ids["f64 solo"], ids["f64 batched"] = solo(), batched()
        out["greedy"][f"seed {seed}"] = {f"{a} == {b}": same(ids[a], ids[b]) for a, b in (
            ("k7 solo", "plain solo"), ("k7 batched", "k7 solo"), ("plain batched", "plain solo"),
            ("f64 batched", "f64 solo"), ("plain solo", "f64 solo"), ("k7 solo", "f64 solo"),
            ("k8 solo", "k7 solo"), ("k8 batched", "k8 solo"), ("k8 solo", "plain solo"))}
        print(f"greedy ids, seed {seed}: " + json.dumps(out["greedy"][f"seed {seed}"]), flush=True)
    table = quant_head_table(qmodel)
    fault_block = min(FAULT_BLOCK, qmodel.config.n_layer - 1)

    out["layers"] = layer_probe(qmodel, ids["plain solo"][0][:len(prompts[0]) + 6])
    for r in out["layers"]:
        print("layers " + json.dumps(r), flush=True)

    @contextlib.contextmanager
    def fault():
        scale = getattr(qmodel.core, f"h_{fault_block}").attn.c_proj.kernel.scale
        kept = scale.clone()
        scale[..., FAULT_COLS] = 0.0
        try:
            yield
        finally:
            scale.copy_(kept)

    with fault():
        ids["fault solo"] = solo()
        kw["megakernel"] = True
        ids["k8 fault solo"] = solo()
        del kw["megakernel"]
    n_prompt = [len(p) for p in prompts]
    out["readings"] = {}
    for name, planted, steps in (
            ("k7 solo", None, True), ("k7 batched", None, True),
            ("plain solo", lambda: env(SUMMER_CLIP_GEMV="0"), True), ("fault solo", fault, True),
            ("k8 solo", None, "mega"), ("k8 batched", None, "mega"),
            ("k8 fault solo", fault, "mega")):
        shares = [reading(qmodel, table, seq, n, planted, steps)
                  for seq, n in zip(ids[name], n_prompt)]
        out["readings"][name] = {"pick_share_max": max(s[0] for s in shares),
                                 "logit_share_max": max(s[1] for s in shares),
                                 "ids == plain solo": same(ids[name], ids["plain solo"])}
        print(f"readings {name}: " + json.dumps(out["readings"][name]), flush=True)

    out["k8_block"] = k8_block_gate(qmodel, fault, fault_block)
    print("k8_block " + json.dumps(out["k8_block"]), flush=True)

    def wall(fn):
        sync = torch.cuda.synchronize if DEVICE == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        return (time.perf_counter() - t0) * 1e3

    out["host"] = {}
    for name, fn in (("device loop", lambda n: gen_gpt.generate_device(
            qmodel, prompts[0], max_new_tokens=n, top_k=1, quant_int8=True)),
                     ("device loop, megakernel", lambda n: gen_gpt.generate_device(
                         qmodel, prompts[0], max_new_tokens=n, top_k=1, quant_int8=True,
                         megakernel=True)),
                     ("host loop", lambda n: gen_gpt.generate(
                         qmodel, prompts[0], max_new_tokens=n, top_k=1))):
        fn(NEW_TOKENS)
        step = (min(wall(lambda: fn(NEW_TOKENS)) for _ in range(3))
                - min(wall(lambda: fn(1)) for _ in range(3))) / (NEW_TOKENS - 1)
        out["host"][name] = {"ms_a_decode_step": step}
        print(f"host {name}: {step:.3f} ms a decode step of wall clock", flush=True)

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
