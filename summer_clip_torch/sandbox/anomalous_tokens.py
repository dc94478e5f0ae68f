"""Anomalous-token analysis sandbox.

Counterpart of ``summer_clip_tpu/sandbox/anomalous_tokens.py``, the rebuild of
the reference's standalone scripts (``summer_clip/clip_prompt/anomalous_tokens/``):
probing a causal LM's embedding space for tokens and inputs with anomalous
behaviour.

- :func:`kmeans` -- cosine k-means over the token-embedding table (the
  reference's ``kkmeans``, helpers.py:68-138), with an optional equal-size
  rebalance (helpers.py:109-127, host-side numpy); the (V, D) @ (D, K)
  distances are one product, outside any kernel;
- :func:`closest_tokens` -- nearest tokens under cosine distance;
- :func:`greedy_rollout` -- the reference's ``model_emb`` (helpers.py:166-190):
  greedy decoding in embedding space through fixed-shape full forwards (no KV
  cache), as the JAX package's ``lax.scan`` runs it, then one differentiable
  forward over the completed sequence;
- :func:`confidence_perplexity` -- ``helpers.perplexity`` (helpers.py:194-198);
- :func:`optimise_input` -- continuous input optimisation (backwards.py:16-216)
  with the reference's whole search surface, on the objective
  :func:`input_loss`;
- :func:`backwards_main` (the ``backwards.py`` CLI) and :func:`main` (the
  generate CLI, through ``apps.gen_gpt.generate_device``).

Every GPT-2 forward of these functions is one wide forward without a cache,
so on the card its attention is K4 (``ops.attention.short_attention_packed``;
under a gradient its ``_ad`` wrapper, whose backward recomputes the plain
version and launches nothing). Where the JAX package draws
``jax.random.permutation(PRNGKey(seed), V)`` (k-means' initial centroids, the
random init), these functions take that permutation as ``permutation`` and
otherwise draw one from a ``torch.Generator`` seeded with ``seed``; the
re-initialisation draws are numpy's, as in the JAX package. ``gpt_apply`` is
``gpt_apply(inputs_embeds) -> logits`` (the JAX package's two-argument form
exists only to keep its compiled programs small).

Run: ``python -m summer_clip_torch.sandbox.anomalous_tokens -m gpt2-large -i
"hello" --checkpoint gpt2.msgpack`` (``--device cpu`` for the CPU); the
``backwards.py`` CLI is ``python -c "from summer_clip_torch.sandbox.anomalous_tokens
import backwards_main; backwards_main()" --model_name gpt2 ...``.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch
import torch.nn.functional as F

from summer_clip_torch.engine import optim

__all__ = ["kmeans", "closest_tokens", "greedy_rollout", "confidence_perplexity",
           "input_loss", "optimise_input", "backwards_main"]

Permutation = tp.Optional[tp.Union[torch.Tensor, np.ndarray, tp.Sequence[int]]]


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def _permutation(v: int, seed: int, permutation: Permutation, device) -> torch.Tensor:
    if permutation is None:
        return torch.randperm(v, generator=torch.Generator().manual_seed(int(seed))).to(device)
    return torch.as_tensor(np.asarray(permutation, np.int64), device=device)


def kmeans(embeddings: torch.Tensor, num_clusters: int, *, max_iter: int = 100,
           threshold: float = 1e-5, seed: int = 0, equal_clusters: bool = False,
           permutation: Permutation = None) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Cosine k-means. Returns (assignments (V,), centroids (K, D)); the
    initial centroids are the rows ``permutation[:K]``.

    ``equal_clusters=True`` mirrors the reference's capacity rebalance
    (helpers.py:109-127): oversized clusters keep their ``V // K`` nearest
    members and spill the rest, farthest-first, into clusters with free space.
    """
    emb = _l2n(torch.as_tensor(embeddings).float())
    centroids = emb[_permutation(emb.shape[0], seed, permutation, emb.device)[:num_clusters]]
    if equal_clusters:
        assign, cents = _kmeans_equal(emb.cpu().numpy(), centroids.cpu().numpy(), num_clusters,
                                      max_iter=max_iter, threshold=threshold)
        return (torch.from_numpy(assign).to(emb.device),
                torch.from_numpy(cents).float().to(emb.device))
    movement, i = float("inf"), 0
    while movement > threshold and i < max_iter:
        assign = (1.0 - emb @ centroids.T).argmin(dim=1)
        one_hot = F.one_hot(assign, num_clusters).to(emb.dtype)
        sums = one_hot.T @ emb
        counts = one_hot.sum(dim=0)[:, None]
        new = _l2n(torch.where(counts > 0, sums / counts.clamp_min(1), centroids))
        movement = float((new - centroids).abs().mean())
        centroids, i = new, i + 1
    return (1.0 - emb @ centroids.T).argmin(dim=1), centroids


def _kmeans_equal(emb: np.ndarray, centroids: np.ndarray, k: int, *,
                  max_iter: int, threshold: float) -> tp.Tuple[np.ndarray, np.ndarray]:
    cap = emb.shape[0] // k
    assign = np.zeros(emb.shape[0], np.int64)
    for _ in range(max_iter):
        dists = 1.0 - emb @ centroids.T               # (V, K)
        assign = dists.argmin(axis=1)
        # rebalance: oversized clusters keep the cap nearest-to-centroid
        # members, spares go to the nearest cluster with free space
        spares: tp.List[int] = []
        for c in range(k):
            members = np.flatnonzero(assign == c)
            if members.size > cap:
                order = np.argsort(dists[members, c])
                spares.extend(members[order[cap:]].tolist())
        if spares:
            spares_a = np.asarray(spares)
            free = np.asarray([max(cap - (assign == c).sum(), 0) for c in range(k)])
            # the farthest spares pick first
            for s in spares_a[np.argsort(-dists[spares_a, assign[spares_a]])]:
                for c in np.argsort(dists[s]):
                    if free[c] > 0:
                        assign[s] = c
                        free[c] -= 1
                        break
        new_centroids = np.stack([
            emb[assign == c].mean(axis=0) if (assign == c).any() else centroids[c]
            for c in range(k)])
        new_centroids /= np.maximum(np.linalg.norm(new_centroids, axis=1, keepdims=True), 1e-12)
        movement = np.abs(new_centroids - centroids).mean()
        centroids = new_centroids
        if movement <= threshold:
            break
    return assign, centroids


def closest_tokens(query: torch.Tensor, embeddings: torch.Tensor, n: int = 10
                   ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """(distances, ids) of the n nearest tokens by cosine distance."""
    emb = _l2n(torch.as_tensor(embeddings).float())
    q = _l2n(torch.atleast_2d(torch.as_tensor(query).float()))
    dists = 1.0 - (q @ emb.T)[0]
    neg_d, ids = torch.topk(-dists, n)
    return -neg_d, ids


def greedy_rollout(gpt_apply: tp.Callable[[torch.Tensor], torch.Tensor],
                   inputs_embeds: torch.Tensor, table: torch.Tensor, out_len: int
                   ) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Reference ``model_emb`` (helpers.py:166-190) at fixed shapes.

    Greedy-decode ``out_len`` tokens in embedding space: step i runs the whole
    (B, L + O, D) sequence without gradient, reads the logits at position
    L + i - 1 and writes ``table[argmax]`` at position L + i (causality makes
    the logits read exact whatever lies beyond). Returns ``(all_logits
    (B, L + O, V), out_ids (B, O), final_seq)``: one differentiable forward
    over the completed sequence gives every logit, so gradients reach
    ``inputs_embeds`` through it only (the argmax feedback is detached).
    """
    b, l, d = inputs_embeds.shape
    fill = inputs_embeds.new_zeros(b, out_len, d, requires_grad=False)
    ids = []
    with torch.no_grad():
        for i in range(out_len):
            logits = gpt_apply(torch.cat([inputs_embeds.detach(), fill], dim=1))
            ix = logits[:, l - 1 + i].argmax(dim=-1)
            fill[:, i] = table[ix].to(fill.dtype)
            ids.append(ix)
    seq = torch.cat([inputs_embeds, fill], dim=1)
    out_ids = (torch.stack(ids, dim=1) if ids
               else torch.zeros(b, 0, dtype=torch.long, device=inputs_embeds.device))
    return gpt_apply(seq), out_ids, seq


def confidence_perplexity(logits: torch.Tensor) -> torch.Tensor:
    """``helpers.perplexity`` (helpers.py:194-198): 1/geomean(max softmax
    prob) - 1 per row, a confidence measure of the greedy path."""
    max_logp = torch.log_softmax(logits.float(), dim=-1).max(dim=-1).values   # (..., T)
    return torch.exp(-max_logp.mean(dim=-1)) - 1.0


def _subseq_found(hay: np.ndarray, needle: np.ndarray) -> bool:
    n = len(needle)
    return any(np.array_equal(hay[i:i + n], needle) for i in range(len(hay) - n + 1))


def input_loss(gpt_apply: tp.Callable[[torch.Tensor], torch.Tensor], inputs: torch.Tensor,
               emb: torch.Tensor, target: torch.Tensor, *, out_len: int,
               dist_reg: float = 0.1, perp_reg: float = 0.0, loss_type: str = "log_prob",
               penalise_repetition: bool = False
               ) -> tp.Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One evaluation of :func:`optimise_input`'s objective at ``inputs``
    (B, L, D), projected to the unit sphere: ``(total, nll (B,), distance
    (B,), perplexity (B,))``, differentiable in ``inputs``. ``emb`` is the
    normalised (V, D) table, ``target`` the (T,) target ids."""
    input_len, t_len = inputs.shape[1], int(target.shape[0])
    x = _l2n(inputs)
    all_logits, _, _ = greedy_rollout(gpt_apply, x, emb, out_len)
    # rollout logits at the output positions: L - 1 .. L + out_len - 2
    out_logits = all_logits[:, input_len - 1: input_len + out_len - 1, :]
    logp = torch.log_softmax(out_logits.float(), dim=-1)
    # window w covers output positions w .. w + t_len - 1; the per-token max
    # over windows mirrors backwards.py:98-100
    windows = (torch.arange(t_len, device=emb.device)[None, :]
               + torch.arange(out_len - t_len + 1, device=emb.device)[:, None])
    target_logp = logp[:, windows, target[None, :]].max(dim=1).values   # (B, T)
    if loss_type == "ce":
        nll = -torch.log_softmax(out_logits[:, 0].float(), dim=-1)[:, target[0]][:, None]
    else:
        nll = -target_logp
    nll_b = nll.mean(dim=1)
    dist_b = (1.0 - torch.einsum("bld,vd->blv", x, emb).max(dim=-1).values).mean(dim=1)
    # confidence perplexity of the whole greedy path (positions 0 .. L + O - 2)
    perp_b = confidence_perplexity(all_logits[:, :-1, :])
    total = torch.stack([dist_b.mean() * dist_reg, nll_b.mean(), perp_b.mean() * perp_reg]).mean()
    if penalise_repetition:
        # the reference's sum (backwards.py:137): target logits over the
        # first min(L, O) rollout output positions
        total = total + out_logits[:, : min(input_len, out_len), :][..., target].sum()
    return total, nll_b, dist_b, perp_b


def optimise_input(gpt_apply: tp.Callable[[torch.Tensor], torch.Tensor],
                   word_embeddings: torch.Tensor,
                   target_ids: tp.Sequence[int], *,
                   input_len: int = 10, batch_size: int = 8, epochs: int = 100,
                   lr: float = 0.1, dist_reg: float = 0.1, perp_reg: float = 0.0,
                   seed: int = 0,
                   init: str = "kmeans",
                   output_len: tp.Optional[int] = None,
                   loss_type: str = "log_prob",
                   penalise_repetition: bool = False,
                   equal_clusters: bool = False,
                   optimiser: str = "adam",
                   lr_decay: bool = False,
                   no_reinit: bool = False,
                   return_early: bool = False,
                   check_freq: int = 10,
                   decode_fn: tp.Optional[tp.Callable[[tp.Sequence[int]], str]] = None,
                   log_fn: tp.Optional[tp.Callable[[dict], None]] = None,
                   permutation: Permutation = None
                   ) -> tp.Dict[str, tp.Any]:
    """Optimise continuous inputs so the LM outputs ``target_ids``.

    The reference search loop (backwards.py:16-216), end to end:

    - rollout: :func:`greedy_rollout` (not teacher forcing: the loss reads the
      target's logits off the model's own greedy continuation);
    - loss per candidate: -log p(target) at the output positions (a per-token
      max over sliding windows when ``output_len`` exceeds the target length,
      backwards.py:98-104), ``dist_reg`` * mean distance to the nearest
      vocabulary token and ``perp_reg`` * confidence perplexity; the three
      terms are averaged (backwards.py:134). ``ce`` is single-token only
      (backwards.py:122-127);
    - ``penalise_repetition`` adds the target's logits summed over the first
      ``min(input_len, output_len)`` rollout positions (backwards.py:136-138);
    - every ``check_freq`` epochs each candidate's nearest-token ids are
      greedy-decoded through the raw embedding table (backwards.py:142);
      candidates whose continuation contains the target (id subsequence, or
      string containment with ``decode_fn``) are recorded and re-initialised
      unless ``no_reinit`` (backwards.py:144-174); ``return_early`` stops at
      the first find;
    - ``lr_decay`` is reduce-on-plateau (factor 0.5, patience 20, cooldown 20,
      backwards.py:87) applied at the check points.

    ``init``: "kmeans" (cluster centroids, optionally ``equal_clusters``),
    "random" (the token embeddings of ``permutation[:input_len *
    batch_size]``) or "local" (tokens nearest the target's mean embedding,
    backwards.py:67-77). ``optimiser``: "adam" (eps 1e-4) or "sgd", from
    ``engine/optim``.
    """
    raw = torch.as_tensor(word_embeddings).float()
    emb = _l2n(raw)    # the reference normalises the table in place (line 53)
    v, d = emb.shape
    target = torch.as_tensor(np.asarray(target_ids, np.int64), device=emb.device)
    t_len = int(target.shape[0])
    out_len = t_len if output_len is None or output_len < t_len else int(output_len)
    if loss_type == "ce" and t_len > 1:
        raise ValueError("CE loss is single-token only (backwards.py:123)")
    if loss_type not in ("log_prob", "ce"):
        raise ValueError(f"unknown loss_type {loss_type!r}")
    host_rng = np.random.default_rng(seed)

    centroids = None
    if init == "random":
        idx = _permutation(v, seed, permutation, emb.device)[: input_len * batch_size]
        x0 = emb[idx].reshape(batch_size, input_len, d)
    elif init == "local":
        _, near = closest_tokens(emb[target].mean(dim=0), emb, n=batch_size)
        x0 = emb[near][:, None, :].repeat(1, input_len, 1)
    else:
        _, centroids = kmeans(emb, batch_size * input_len, seed=seed,
                              equal_clusters=equal_clusters, permutation=permutation)
        x0 = centroids.reshape(batch_size, input_len, d)

    inputs = x0.clone().requires_grad_(True)
    if optimiser == "adam":
        tx = optim.adam({"inputs": inputs}, lr, eps=1e-4)
    elif optimiser == "sgd":
        tx = optim.sgd({"inputs": inputs}, lr)
    else:
        raise ValueError(f"unsupported optimiser {optimiser!r}")

    def nearest_ids() -> np.ndarray:
        with torch.no_grad():
            return torch.einsum("bld,vd->blv", _l2n(inputs), emb).argmax(dim=-1).cpu().numpy()

    def decode_ids(ids: np.ndarray) -> np.ndarray:
        # the success check decodes through the raw table: the model's real
        # token embeddings, like the reference's model.generate(closest_ix)
        with torch.no_grad():
            rows = raw[torch.as_tensor(ids, device=raw.device)]
            return greedy_rollout(gpt_apply, rows, raw, out_len)[1].cpu().numpy()

    target_np = np.asarray(target_ids, np.int64)
    target_str = decode_fn(list(target_np)) if decode_fn else None
    found: tp.List[dict] = []
    found_keys: tp.Set[tp.Tuple[int, ...]] = set()
    best_loss, plateau_wait, cooldown, cur_lr = np.inf, 0, 0, lr
    nll_b = dist_b = perp_b = None
    epochs_run = 0

    for e in range(epochs):
        total, nll_b, dist_b, perp_b = input_loss(
            gpt_apply, inputs, emb, target, out_len=out_len, dist_reg=dist_reg,
            perp_reg=perp_reg, loss_type=loss_type, penalise_repetition=penalise_repetition)
        total.backward()
        total, nll_b, dist_b, perp_b = (v.detach() for v in (total, nll_b, dist_b, perp_b))
        tx.step()
        tx.zero_grad()
        epochs_run = e + 1
        if (e + 1) % check_freq != 0 and e + 1 != epochs:
            continue
        near = nearest_ids()                                # (B, L)
        outs = decode_ids(near)                             # (B, O)
        total_f = float(total)
        nll_np, dist_np, perp_np = (a.cpu().numpy() for a in (nll_b, dist_b, perp_b))
        hit = False
        for b in range(batch_size):
            if decode_fn is not None:
                ok = target_str in decode_fn(list(outs[b]))
            else:
                ok = _subseq_found(outs[b], target_np)
            key = tuple(near[b].tolist()) + tuple(outs[b].tolist())
            if ok and key not in found_keys:
                found_keys.add(key)
                found.append({
                    "input_ids": near[b].tolist(),
                    "output_ids": outs[b].tolist(),
                    "loss": float(nll_np[b]),
                    "perplexity": float(perp_np[b]),
                    "distance": float(dist_np[b]),
                    "epoch": e + 1,
                })
                hit = True
                if not no_reinit:
                    with torch.no_grad():
                        if centroids is not None:
                            pick = host_rng.integers(0, centroids.shape[0], size=input_len)
                            inputs[b] = centroids[torch.as_tensor(pick, device=emb.device)]
                        else:
                            pick = host_rng.permutation(v)[:input_len]
                            inputs[b] = emb[torch.as_tensor(pick, device=emb.device)]
        if log_fn is not None:
            log_fn({"type": "optimise_input", "epoch": e + 1, "total_loss": total_f,
                    "nll": float(nll_np.mean()), "token_dist": float(dist_np.mean()),
                    "perplexity": float(perp_np.mean()), "lr": cur_lr,
                    "num_found": len(found)})
        if lr_decay:
            if total_f < best_loss - 1e-12:
                best_loss, plateau_wait = total_f, 0
            elif cooldown > 0:
                cooldown -= check_freq
            else:
                plateau_wait += check_freq
                if plateau_wait >= 20:
                    cur_lr *= 0.5
                    plateau_wait, cooldown = 0, 20
                    tx.learning_rate = cur_lr
        if hit and return_early:
            break

    nll_np, dist_np, perp_np = (a.cpu().numpy() for a in (nll_b, dist_b, perp_b))
    return {
        "inputs": _l2n(inputs.detach()),
        "nearest_token_ids": nearest_ids(),
        "losses": nll_np + dist_reg * dist_np + perp_reg * perp_np,
        "nll": nll_np,
        "distances": dist_np,
        "perplexities": perp_np,
        "found": found,
        "epochs_run": epochs_run,
        "final_lr": cur_lr,
    }


def _gpt_apply(model) -> tp.Callable[[torch.Tensor], torch.Tensor]:
    return lambda inputs_embeds: model(inputs_embeds=inputs_embeds)["logits"]


def backwards_main(argv: tp.Optional[tp.Sequence[str]] = None) -> tp.Dict[str, tp.Any]:
    """The ``backwards.py`` CLI (backwards.py:219-288): optimise inputs for a
    target (or a curated test set, or random targets), logging metrics and
    the found-inputs table through the experiment logger. Without
    ``--checkpoint`` the weights are drawn from seed 0."""
    import argparse

    from summer_clip_torch.core.device import resolve_device
    from summer_clip_torch.core.log_utils import JsonlLogger, NullExpLogger
    from summer_clip_torch.sandbox.create_trigger import load_gpt2

    p = argparse.ArgumentParser(description="anomalous-token input optimisation")
    p.add_argument("--model_name", default="test-gpt")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--no_reinit", action="store_true")
    p.add_argument("--w_freq", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--input_len", type=int, default=10)
    p.add_argument("--target", type=int, nargs="+", default=[7],
                   help="target token id(s)")
    p.add_argument("--output_len", type=int, default=None)
    p.add_argument("--dist_reg", type=float, default=0.1)
    p.add_argument("--perp_reg", type=float, default=0.0)
    p.add_argument("--loss_type", default="log_prob", choices=["log_prob", "ce"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--return_early", action="store_true")
    p.add_argument("--lr_decay", action="store_true")
    p.add_argument("--init", default="kmeans", choices=["kmeans", "random", "local"])
    p.add_argument("--optimiser", default="adam", choices=["adam", "sgd"])
    p.add_argument("--equal_clusters", action="store_true")
    p.add_argument("--penalise_repetition", action="store_true")
    p.add_argument("--run_test_set", type=int, nargs="*", default=None,
                   help="token ids to sweep as single-token targets")
    p.add_argument("--run_random", type=int, default=0,
                   help="optimise N uniformly random single-token targets")
    p.add_argument("--log", default=None, help="JSONL metrics path")
    p.add_argument("--device", default=None, help="default: the card; cpu for the CPU")
    args = p.parse_args(argv)

    model, cfg = load_gpt2(args.model_name, args.checkpoint, 0, resolve_device(args.device))
    logger = JsonlLogger(args.log) if args.log else NullExpLogger()

    if args.run_test_set is not None:
        targets = [[t] for t in args.run_test_set]
    elif args.run_random > 0:
        host = np.random.default_rng(args.seed)
        targets = [[int(host.integers(0, cfg.vocab_size))] for _ in range(args.run_random)]
    else:
        targets = [list(args.target)]

    runs = []
    for tgt in targets:
        out = optimise_input(
            _gpt_apply(model), model.wte.embedding, tgt, input_len=args.input_len,
            batch_size=args.batch_size, epochs=args.epochs, lr=args.lr,
            dist_reg=args.dist_reg, perp_reg=args.perp_reg, seed=args.seed,
            init=args.init, output_len=args.output_len, loss_type=args.loss_type,
            penalise_repetition=args.penalise_repetition,
            equal_clusters=args.equal_clusters, optimiser=args.optimiser,
            lr_decay=args.lr_decay, no_reinit=args.no_reinit,
            return_early=args.return_early, check_freq=args.w_freq, log_fn=logger.log)
        logger.log_table(
            "optimised_inputs",
            ["Input", "Output", "Loss", "Perplexity", "Distance", "Epoch"],
            [[f["input_ids"], f["output_ids"], f["loss"], f["perplexity"],
              f["distance"], f["epoch"]] for f in out["found"]])
        print(f"target={tgt}: found={len(out['found'])} "
              f"epochs_run={out['epochs_run']} final_lr={out['final_lr']:.4f}")
        runs.append({"target": tgt, "num_found": len(out["found"]),
                     "found": out["found"], "epochs_run": out["epochs_run"]})
    logger.finish()
    return {"runs": runs}


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> str:
    """Generation CLI (reference ``anomalous_tokens/generate.py``): tokenize
    an input, print its per-token decomposition, greedy-decode a
    continuation through ``apps.gen_gpt.generate_device``, print the output
    text. Without ``--checkpoint`` the weights are drawn from seed 0."""
    import argparse

    from summer_clip_torch.apps.gen_gpt import generate_device
    from summer_clip_torch.core.device import resolve_device
    from summer_clip_torch.models.tokenizer import get_tokenizer
    from summer_clip_torch.sandbox.create_trigger import load_gpt2

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-m", "--model", default="gpt2", help="GPT2_CONFIGS name")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output-length", type=int, default=20)
    p.add_argument("--checkpoint", default=None, help="the model's tree, msgpack or torch")
    p.add_argument("--device", default=None, help="default: the card; cpu for the CPU")
    args = p.parse_args(argv)

    tok = get_tokenizer()
    model, cfg = load_gpt2(args.model, args.checkpoint, 0, resolve_device(args.device))
    ix = [i % cfg.vocab_size for i in tok.encode(args.input)]
    print(f"{len(ix)} input tokens: {[tok.decode([i]) for i in ix]}")
    out_ids = generate_device(model, ix, max_new_tokens=int(args.output_length), top_k=1)
    text = tok.decode(out_ids)
    print(f"\nOutput:\n{text}")
    return text


if __name__ == "__main__":
    main()
