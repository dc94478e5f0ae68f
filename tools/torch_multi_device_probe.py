#!/usr/bin/env python3
"""What the port's multi-device layer finds on this host's cards (a minute or two).

    python tools/torch_multi_device_probe.py

1. Two ranks on one card with gloo (``parallel.launch``): whether all_reduce,
   broadcast, all_gather and gather take CUDA tensors, and the ms of an all_reduce at
   the sizes the port reduces (a decode step's row-parallel partial at 1, 3
   and 8 rows of gpt2-large's 1280, CLIP-search's (8, 1000, 1000) partial
   logits), median of 20 after 3 warm-ups.
2. Two ranks on one card with NCCL: whether the group refuses them (and the
   error it gives), under a 60 s timeout.
3. One rank through NCCL: the same all_reduce times.
4. On the card at tp = 2 (gloo, one card shared): the int8 ClipGPT of
   ``test-gpt-mega`` (4 heads, width 256, every slice tile-legal) through the
   device loop, the batched sampler and the engine, against the one-device
   run; K7's launches per rank. The resident sharded cache over 2 ranks
   against the one-device route of the same rows (K3 / K2 / K1 a rank).
5. ``gather_rows`` of bf16 and f32 CUDA rows from 2 ranks to rank 0, and
   data-parallel extraction (``apps.common.extract_image_features``) of 1024
   synthetic 224 px images through ``ImageBatcher`` at ViT-B/16, batch 32:
   rank 0's features at world 2 (gloo, one card shared) against one device,
   and img/s end to end (rendering, transfer, tower, gather) at world 1 (one
   process, no group) and world 2, each after a warm-up pass, beside each
   rank's seconds of rendering its batches alone.

Prints one JSON line of the readings last; exits non-zero on a failed check.
"""

from __future__ import annotations

import datetime
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

SIZES = {"decode R=1": (1, 1, 1280), "decode R=3": (3, 1, 1280), "engine R=8": (8, 1, 1280),
         "cache partial": (8, 1000, 1000)}


def _time_all_reduce(device) -> dict:
    import torch
    import torch.distributed as dist

    out = {}
    for name, shape in SIZES.items():
        x = torch.ones(shape, device=device)
        times = []
        for i in range(23):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            dist.all_reduce(x)
            torch.cuda.synchronize(device)
            if i >= 3:
                times.append((time.perf_counter() - t0) * 1e3)
        out[name] = sorted(times)[len(times) // 2]
    return out


def collectives_rank() -> dict:
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", torch.cuda.current_device())
    rank, world = dist.get_rank(), dist.get_world_size()
    facts = {}
    for op in ("all_reduce", "broadcast", "all_gather", "gather"):
        try:
            x = torch.full((4,), float(rank + 1), device=dev)
            if op == "all_reduce":
                dist.all_reduce(x)
                ok = x.tolist() == [float(sum(range(1, world + 1)))] * 4
            elif op == "broadcast":
                dist.broadcast(x, 0)
                ok = x.tolist() == [1.0] * 4
            elif op == "all_gather":
                parts = [torch.empty_like(x) for _ in range(world)]
                dist.all_gather(parts, x)
                ok = [p[0].item() for p in parts] == [float(r + 1) for r in range(world)]
            else:
                parts = [torch.empty_like(x) for _ in range(world)] if rank == 0 else None
                dist.gather(x, parts, dst=0)
                ok = rank != 0 or [p[0].item() for p in parts] == [float(r + 1) for r in range(world)]
            facts[op] = "ok" if ok else "wrong values"
        except Exception as exc:   # noqa: BLE001 - the probe records what the backend refuses
            facts[op] = f"{type(exc).__name__}: {str(exc)[:200]}"
    return {"facts": facts, "ms": _time_all_reduce(dev)}


def tp_rank(tree) -> dict:
    import torch
    import torch.distributed as dist

    from summer_clip_torch.apps import gen_gpt
    from summer_clip_torch.engine.serving import ContinuousBatcher
    from summer_clip_torch.models import gpt2 as tg
    from summer_clip_torch.ops import gemv
    from summer_clip_torch.parallel import create_mesh

    model = tg.ClipGPT(tg.GPT2_CONFIGS["test-gpt-mega"], clip_vocab_size=512, clip_emb_dim=128,
                       emb_hid_dim=128, head_hid_dim=128, device="cuda")
    model = model.load_tree(tree, device="cuda").eval()
    mesh = create_mesh(data=1, model=dist.get_world_size())
    kw = dict(max_new_tokens=12, top_k=1, quant_int8=True)
    prompts = [[3, 14, 15, 2], [9, 2, 6, 5, 3, 7], [11]]
    out = {"solo": [gen_gpt.generate_device(model, p, **kw) for p in prompts]}
    gemv.streamed_qmatmul.launches = 0
    out["device"] = [gen_gpt.generate_device(model, p, mesh=mesh, **kw) for p in prompts]
    out["k7_device"] = gemv.streamed_qmatmul.launches
    out["batched"] = gen_gpt.generate_device_batched(model, prompts, mesh=mesh, **kw)
    out["solo_batched"] = gen_gpt.generate_device_batched(model, prompts, **kw)
    for name, m in (("engine", mesh), ("solo_engine", None)):
        eng = ContinuousBatcher(model, batch_slots=2, max_len=48, greedy=True, quant_int8=True,
                                mesh=m, burst=4, pipeline=2)
        reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
        eng.run()
        out[name] = [r.out_ids for r in reqs]
    return out


def cache_rank(case) -> dict:
    import numpy as np
    import torch
    import torch.distributed as dist

    from summer_clip_torch.ops import cache_kernels as ck
    from summer_clip_torch.parallel import ShardedResidentCache, create_mesh

    mesh = create_mesh(data=1, model=dist.get_world_size())
    res = ShardedResidentCache(case["cache"], case["outs"], mesh)
    f = torch.from_numpy(case["f"]).cuda()
    out = {}
    for sel, inds in (("all", np.arange(case["cache"].shape[0])), ("subset", case["subset"])):
        for kind in ("hard", "softmax"):
            counts = {k: getattr(ck, k).launches for k in
                      ("cache_attention", "cache_attention_labels", "cache_attention_onehot")}
            got = res.logits(f, inds, case["betas"], kind=kind, scale=5.0).cpu().numpy()
            out[sel, kind] = got
            out[sel, kind, "launches"] = {k: getattr(ck, k).launches - v for k, v in counts.items()}
    return out


def _extract_timed(mesh, n_images: int) -> tuple:
    """Rank-local: ViT-B/16 features of ``n_images`` synthetic images through
    ``ImageBatcher`` (batch 32) with ``mesh``, after a warm-up pass of 64;
    returns (features, seconds of the timed pass, seconds of this rank's
    batches rendered alone, without the tower)."""
    import torch

    from summer_clip_torch.apps.common import create_clip_session, extract_image_features
    from summer_clip_torch.data.datasets import SyntheticDataset
    from summer_clip_torch.data.loader import ImageBatcher
    from summer_clip_torch.data.transforms import EvalTransform

    session = create_clip_session("ViT-B/16", mesh=mesh)
    items = SyntheticDataset(num_classes=8, per_class=n_images // 8, image_size=224).train_x
    extract_image_features(session, ImageBatcher(items[:64], 32, EvalTransform(224)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = extract_image_features(session, ImageBatcher(items, 32, EvalTransform(224)))[0]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    batcher = ImageBatcher(items, 32, EvalTransform(224))
    if mesh is not None:
        batcher = batcher.shard(mesh.coords["data"], mesh.shape["data"])
    t0 = time.perf_counter()
    for _ in batcher:
        pass
    return feats, seconds, time.perf_counter() - t0


def gather_rank(n_images: int) -> dict:
    """``gather_rows`` of bf16 and f32 CUDA rows to rank 0, then data-parallel
    extraction over the group (rank 0 also extracts alone, without a mesh)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from summer_clip_torch.parallel import create_mesh, gather_rows

    mesh = create_mesh()
    rank = dist.get_rank()
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        parts = [torch.randn(16, 512, generator=torch.Generator().manual_seed(r)).to(dtype)
                 for r in range(dist.get_world_size())]
        got = gather_rows(parts[rank].cuda(), mesh, "data")
        out[f"gather {dtype}"] = (got is None) if rank else bool(torch.equal(got.cpu(),
                                                                             torch.cat(parts)))
    dp, out["dp_seconds"], out["dp_render_seconds"] = _extract_timed(mesh, n_images)
    out["dp_rows"] = int(len(dp))
    dist.barrier()
    if rank == 0:
        one, out["one_seconds"], out["one_render_seconds"] = _extract_timed(None, n_images)
        out["dp_max_abs"] = float(np.abs(dp - one).max())
    return out


def _one_device_cache(case, inds, kind):
    """The one-device route of ``apps/image_attention``: the selected rows of
    the prediction-sorted cache gathered, padded to 1024, labels (K3 / K2) or
    Softmax values (K1)."""
    import numpy as np
    import torch

    from summer_clip_torch.ops import cache_kernels as ck

    outs = case["outs"]
    preds = outs.argmax(1).astype(np.int32)
    order = np.argsort(preds, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    pos = np.sort(rank[inds])
    cf = case["cache"] / np.linalg.norm(case["cache"], axis=1, keepdims=True)
    rows = cf[order][pos]
    pad = (-len(pos)) % 1024
    rows = np.concatenate([rows, np.zeros((pad, rows.shape[1]), np.float32)])
    f = torch.from_numpy(case["f"]).cuda()
    c = torch.from_numpy(rows).cuda()
    if kind == "hard":
        labels = np.full(rows.shape[0], -1, np.int32)
        labels[:len(pos)] = preds[order][pos]
        return ck.cache_attention_from_labels(f, c, labels, case["betas"], outs.shape[1])
    v = torch.softmax(5.0 * torch.from_numpy(outs[order][pos]).cuda(), dim=1)
    v = torch.cat([v, torch.zeros(pad, v.shape[1], device="cuda")]).to(torch.bfloat16)
    return ck.cache_attention(f, c, v, case["betas"])


def main() -> int:
    import numpy as np
    import torch

    from summer_clip_torch.parallel import launch

    if not torch.cuda.is_available():
        print("torch_multi_device_probe: no CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} card(s)", flush=True)
    readings: dict = {"card": card}
    t0 = time.perf_counter()
    gloo = launch(collectives_rank, ["cuda:0", "cuda:0"], backend="gloo")
    readings["gloo_shared_card"] = gloo[0].value
    print(f"gloo, 2 ranks on one card: {json.dumps(gloo[0].value)}", flush=True)
    try:
        nccl2 = launch(_nccl_two_rank, ["cuda:0", "cuda:0"], backend="nccl")
        readings["nccl_shared_card"] = {"refused": False, "value": nccl2[0].value}
    except Exception as exc:   # noqa: BLE001 - the refusal is the reading
        text = str(exc)
        hit = [line for line in text.splitlines() if "uplicate" in line or "nccl" in line.lower()]
        readings["nccl_shared_card"] = {"refused": True, "error": (hit or [text])[-1][:300]}
    print(f"nccl, 2 ranks on one card: {json.dumps(readings['nccl_shared_card'])}", flush=True)
    nccl1 = launch(collectives_rank, ["cuda:0"], backend="nccl")
    readings["nccl_one_rank"] = nccl1[0].value
    print(f"nccl, 1 rank: {json.dumps(nccl1[0].value)}", flush=True)

    from summer_clip_torch.models import gpt2 as tg
    from summer_clip_torch.engine.quant import quantize_tree

    m = tg.ClipGPT(tg.GPT2_CONFIGS["test-gpt-mega"], clip_vocab_size=512, clip_emb_dim=128,
                   emb_hid_dim=128, head_hid_dim=128, device="cpu")
    m.init_weights(torch.Generator().manual_seed(0))
    tree = quantize_tree(m.tree())
    tp = launch(tp_rank, ["cuda:0", "cuda:0"], tree)
    ok = True
    for r in tp:
        v = r.value
        same = {k: v[k] == v[f"solo_{k}" if k != "device" else "solo"]
                for k in ("device", "batched", "engine")}
        ok = ok and all(same.values()) and v == tp[0].value
        print(f"tp=2 rank: ids equal to one device {same}; K7 launches in the device loop "
              f"{v['k7_device']} (wrapper count), all ranks alike: {v == tp[0].value}", flush=True)
    readings["tp2_test_gpt_mega"] = {"ids_equal": ok, "k7_device": tp[0].value["k7_device"]}

    rng = np.random.RandomState(0)
    case = {"f": rng.randn(100, 768).astype(np.float32), "betas": [1.0, 5.5],
            "cache": rng.randn(3000, 768).astype(np.float32),
            "outs": rng.randn(3000, 300).astype(np.float32)}
    case["f"] /= np.linalg.norm(case["f"], axis=1, keepdims=True)
    case["subset"] = np.sort(rng.choice(3000, 700, replace=False))
    cache = launch(cache_rank, ["cuda:0", "cuda:0"], case)
    errs = {}
    for sel, inds in (("all", np.arange(3000)), ("subset", case["subset"])):
        for kind in ("hard", "softmax"):
            want = _one_device_cache(case, inds, kind).cpu().numpy()
            got = cache[0].value[sel, kind]
            errs[f"{sel} {kind}"] = float(np.abs(got - want).max() / np.abs(want).max())
            same = all(np.array_equal(c.value[sel, kind], got) for c in cache)
            print(f"sharded cache {sel} {kind}: max|d| / max|ref| {errs[f'{sel} {kind}']:.3e} "
                  f"against the one-device route, ranks alike {same}, launches per rank "
                  f"{[c.value[sel, kind, 'launches'] for c in cache]}", flush=True)
            ok = ok and same and errs[f"{sel} {kind}"] < 2e-3
    readings["sharded_cache_rel_err"] = errs
    n_images = 1024
    gathered = [g.value for g in launch(gather_rank, ["cuda:0", "cuda:0"], n_images)]
    g0 = gathered[0]
    readings["gather"] = gathered
    readings["extraction_img_per_s"] = {"world 1": n_images / g0["one_seconds"],
                                        "world 2 (one card shared)": n_images / g0["dp_seconds"]}
    print(f"gather_rows and data-parallel extraction: {json.dumps(gathered)}; img/s "
          f"{json.dumps(readings['extraction_img_per_s'])}", flush=True)
    ok = ok and all(all(v for k, v in g.items() if k.startswith("gather")) for g in gathered)
    ok = ok and g0["dp_rows"] == n_images and gathered[1]["dp_rows"] == 0
    ok = ok and g0["dp_max_abs"] <= 1e-4
    readings["seconds"] = time.perf_counter() - t0
    readings["when"] = datetime.datetime.now(datetime.timezone.utc).isoformat()
    print(json.dumps(readings))
    return 0 if ok else 1


def _nccl_two_rank() -> dict:
    import datetime as dt

    import torch
    import torch.distributed as dist

    x = torch.ones(4, device="cuda")
    work = dist.all_reduce(x, async_op=True)
    work.wait(timeout=dt.timedelta(seconds=60))
    torch.cuda.synchronize()
    return {"sum": x.tolist()}


if __name__ == "__main__":
    os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "1")
    sys.exit(main())
