"""AutoPrompt trigger search: templatizer + dataset + eval loop + search app.

Counterpart of ``summer_clip_tpu/sandbox/create_trigger.py``, the surface of
the reference's vendored ucinlp/autoprompt (``create_trigger.py:57-134`` and
``autoprompt/utils.py:57`` onward) on the primitives of
:mod:`summer_clip_torch.sandbox.mlm_trigger`:

- :class:`Templatizer` -- formats ``"[T] [T] {sentence} [P]"``-style templates
  over label-map datasets into fixed-shape id/mask arrays (numpy);
- :func:`load_trigger_dataset` -- tsv/jsonl example loaders;
- :func:`label_loss` -- multi-token label scoring
  (``-logsumexp(log p(label tokens))`` with pad masking, reference
  ``get_loss``);
- :class:`AccuracyFn` -- label-map accuracy: the gold label's log-prob must
  beat every other label's (reference ``AccuracyFn.__call__``);
- :func:`build_token_filter` -- -1e32 mask over label/special/capitalized
  tokens (reference ``run_model`` filter construction);
- :class:`TriggerSearch` -- the gradient-accumulation + HotFlip candidate
  re-evaluation + dev-eval loop (reference ``run_model``). The gradient with
  respect to the trigger embeddings is ``torch.autograd.grad`` through the
  frozen LM (on the card its attention is K4 through
  ``ops.attention.short_attention_packed_ad``); the current trigger and every
  candidate are scored on a batch in one forward, as the JAX package's
  vmapped program does. Batches are drawn by the same numpy generator, so a
  seed draws the JAX package's batches and slots.

Works with causal LMs (the GPT-2 family: position p is predicted from the
logits at p - 1) and mask-predicting LMs (``causal=False``).

Run: ``python -m summer_clip_torch.sandbox.create_trigger --train t.tsv --dev
d.tsv --template "[T] [T] [T] {sentence} [P]" --label-map '{"0": "bad", "1":
"good"}' --checkpoint gpt2.msgpack`` (``--device cpu`` for the CPU).
"""

from __future__ import annotations

import csv
import json
import typing as tp
from pathlib import Path

import numpy as np
import torch

__all__ = [
    "TriggerExample", "Templatizer", "load_trigger_dataset", "encode_label",
    "label_loss", "AccuracyFn", "build_token_filter", "TriggerSearch",
]


class TriggerExample(tp.NamedTuple):
    input_ids: np.ndarray     # (T,) int32, padded to the templatizer's max_len
    trigger_mask: np.ndarray  # (T,) bool: trigger slots
    predict_mask: np.ndarray  # (T,) bool: exactly one predict slot
    label_ids: np.ndarray     # (L,) int32, 0-padded (multi-token labels)


def encode_label(encode_fn: tp.Callable[[str], tp.List[int]],
                 label: tp.Union[str, int, tp.Sequence[int]],
                 max_label_len: int = 4) -> np.ndarray:
    """Label -> 0-padded id row (reference ``utils.encode_label``)."""
    if isinstance(label, str):
        ids = list(encode_fn(label))
    elif isinstance(label, int):
        ids = [label]
    else:
        ids = [int(i) for i in label]
    if not ids or len(ids) > max_label_len:
        raise ValueError(f"label {label!r} encodes to {len(ids)} tokens "
                         f"(max {max_label_len})")
    out = np.zeros(max_label_len, np.int32)
    out[:len(ids)] = ids
    return out


class Templatizer:
    """Format a ``[T]``/``[P]``/``{field}`` template into fixed-shape arrays.

    The template is split on the markers and each literal/field chunk is
    encoded on its own, so no vocabulary surgery is needed and any
    ``encode(text) -> List[int]`` callable works.
    """

    def __init__(self, template: str,
                 encode_fn: tp.Callable[[str], tp.List[int]],
                 mask_id: int, *,
                 label_map: tp.Optional[tp.Mapping[str, tp.Any]] = None,
                 label_field: str = "label",
                 max_len: int = 64, max_label_len: int = 4,
                 pad_id: int = 0):
        self.encode_fn = encode_fn
        self.mask_id = int(mask_id)
        self.label_map = dict(label_map) if label_map is not None else None
        self.label_field = label_field
        self.max_len = max_len
        self.max_label_len = max_label_len
        self.pad_id = int(pad_id)
        self.pieces: tp.List[tp.Tuple[str, str]] = []  # (kind, payload)
        for tok in template.split():
            if tok == "[T]":
                self.pieces.append(("trigger", ""))
            elif tok == "[P]":
                self.pieces.append(("predict", ""))
            elif tok.startswith("{") and tok.endswith("}"):
                self.pieces.append(("field", tok[1:-1]))
            else:
                self.pieces.append(("literal", tok))
        self.num_trigger_tokens = sum(1 for k, _ in self.pieces if k == "trigger")
        if sum(1 for k, _ in self.pieces if k == "predict") != 1:
            raise ValueError("template must contain exactly one [P] slot")

    def __call__(self, example: tp.Mapping[str, tp.Any]) -> TriggerExample:
        example = dict(example)
        label = example.pop(self.label_field)
        if label is None:
            raise ValueError(f"bad example (no {self.label_field}): {example}")
        if self.label_map is not None:
            label = self.label_map[str(label)]

        ids: tp.List[int] = []
        trig: tp.List[bool] = []
        pred: tp.List[bool] = []

        def push(token_ids: tp.Sequence[int], is_t: bool = False, is_p: bool = False):
            for t in token_ids:
                ids.append(int(t))
                trig.append(is_t)
                pred.append(is_p)

        for kind, payload in self.pieces:
            if kind == "trigger":
                push([self.mask_id], is_t=True)
            elif kind == "predict":
                push([self.mask_id], is_p=True)
            elif kind == "field":
                push(self.encode_fn(str(example[payload])))
            else:
                push(self.encode_fn(payload))
        if len(ids) > self.max_len:
            raise ValueError(f"templated example length {len(ids)} > max_len {self.max_len}")
        pad = self.max_len - len(ids)
        input_ids = np.asarray(ids + [self.pad_id] * pad, np.int32)
        trigger_mask = np.asarray(trig + [False] * pad)
        predict_mask = np.asarray(pred + [False] * pad)
        label_ids = encode_label(self.encode_fn, label, self.max_label_len)
        return TriggerExample(input_ids, trigger_mask, predict_mask, label_ids)


MAX_CONTEXT_LEN = 50


def load_trigger_dataset(path: tp.Union[str, Path], templatizer: Templatizer,
                         limit: tp.Optional[int] = None, use_ctx: bool = False,
                         rng: tp.Optional[np.random.Generator] = None
                         ) -> tp.List[TriggerExample]:
    """tsv (DictReader) / jsonl loaders (reference ``utils.load_trigger_dataset``).
    Examples that fail to templatize (too long, bad label) are skipped.

    ``use_ctx``: relation-extraction mode -- each jsonl row carries
    ``evidences`` [{obj_surface, masked_sentence}]; one evidence is sampled,
    truncated to ``MAX_CONTEXT_LEN`` words, its ``[MASK]`` replaced by the
    surface form, and exposed to the template as ``{context}``."""
    path = Path(path)
    rng = rng or np.random.default_rng(0)
    if path.suffix == ".tsv":
        with open(path) as f:
            rows: tp.Iterable[dict] = list(csv.DictReader(f, delimiter="\t"))
    elif path.suffix == ".jsonl":
        with open(path) as f:
            rows = [json.loads(line) for line in f if line.strip()]
    else:
        raise ValueError(f"unsupported dataset format: {path.suffix}")
    out: tp.List[TriggerExample] = []
    for row in rows:
        if use_ctx:
            evidences = row.get("evidences")
            if not evidences:
                continue  # a sample without context sentences
            ev = evidences[int(rng.integers(0, len(evidences)))]
            words = str(ev["masked_sentence"]).split()
            sent = " ".join(words[:MAX_CONTEXT_LEN])
            row = dict(row, context=sent.replace("[MASK]", str(ev["obj_surface"])))
        try:
            out.append(templatizer(row))
        except (ValueError, KeyError):
            continue
        if limit is not None and len(out) >= limit:
            break
    return out


def collate(examples: tp.Sequence[TriggerExample]) -> tp.Dict[str, np.ndarray]:
    return {
        "input_ids": np.stack([e.input_ids for e in examples]),
        "trigger_mask": np.stack([e.trigger_mask for e in examples]),
        "predict_mask": np.stack([e.predict_mask for e in examples]),
        "label_ids": np.stack([e.label_ids for e in examples]),
    }


def label_loss(predict_logits: torch.Tensor, label_ids: torch.Tensor) -> torch.Tensor:
    """-log p(label) with multi-token labels 0-padded (reference ``get_loss``)."""
    logp = torch.log_softmax(predict_logits.float(), dim=-1)
    label_ids = label_ids.to(logp.device).long()
    tgt = logp.gather(-1, label_ids) - 1e32 * (label_ids == 0)
    return -torch.logsumexp(tgt, dim=-1)


class AccuracyFn:
    """Correct iff the gold label's log-prob >= every other mapped label's
    (reference ``AccuracyFn``: ``ge_count.le(1)``)."""

    def __init__(self, all_label_ids: tp.Sequence[np.ndarray],
                 labels: tp.Optional[tp.Sequence[str]] = None):
        self.all_label_ids = torch.stack([torch.as_tensor(np.asarray(l)) for l in all_label_ids])
        self.labels = list(labels) if labels is not None else None

    @classmethod
    def from_label_map(cls, encode_fn, label_map: tp.Mapping[str, tp.Any],
                       max_label_len: int = 4) -> "AccuracyFn":
        names, rows = [], []
        for name, toks in label_map.items():
            names.append(name)
            rows.append(encode_label(encode_fn, toks, max_label_len))
        return cls(rows, names)

    def all_label_logp(self, predict_logits: torch.Tensor) -> torch.Tensor:
        """(B, n_labels) log-prob of every mapped label."""
        b = predict_logits.shape[0]
        return torch.stack([-label_loss(predict_logits, ids.expand(b, ids.shape[0]))
                            for ids in self.all_label_ids], dim=1)

    def __call__(self, predict_logits: torch.Tensor, gold_label_ids: torch.Tensor) -> torch.Tensor:
        gold_logp = -label_loss(predict_logits, gold_label_ids)
        all_logp = self.all_label_logp(predict_logits)
        ge_count = (all_logp >= gold_logp[:, None]).sum(dim=-1)
        return (ge_count <= 1).float()

    def predict(self, predict_logits: torch.Tensor) -> tp.List[str]:
        idx = self.all_label_logp(predict_logits).argmax(dim=-1).cpu().tolist()
        if self.labels is None:
            return [str(i) for i in idx]
        return [self.labels[i] for i in idx]


def build_token_filter(vocab_size: int, *,
                       label_ids: tp.Sequence[np.ndarray] = (),
                       special_ids: tp.Sequence[int] = (),
                       decode_fn: tp.Optional[tp.Callable[[tp.List[int]], str]] = None
                       ) -> np.ndarray:
    """(V,) additive mask: -1e32 on label tokens, special tokens, and
    capitalized word-initial tokens (reference filter construction +
    ``isupper``)."""
    filt = np.zeros(vocab_size, np.float32)
    for row in label_ids:
        for t in np.asarray(row).reshape(-1):
            if t != 0:
                filt[int(t)] = -1e32
    for t in special_ids:
        filt[int(t)] = -1e32
    if decode_fn is not None:
        for idx in range(vocab_size):
            if filt[idx] != 0.0:
                continue
            try:
                word = decode_fn([idx])
            except (KeyError, IndexError, ValueError, UnicodeDecodeError):
                continue    # an id the tokenizer has no string for
            stripped = word.lstrip(" ")
            if stripped[:1].isupper():
                filt[idx] = -1e32
    return filt


class TriggerSearch:
    """The ``create_trigger.run_model`` loop.

    ``model_fn(input_embeds) -> (B, T, V) logits`` is the frozen LM forward
    (embeddings in, so gradients flow to the trigger slots);
    ``embedding_table`` is its (V, D) input embedding matrix, on the device
    the search runs on.
    """

    def __init__(self, model_fn: tp.Callable[[torch.Tensor], torch.Tensor],
                 embedding_table: torch.Tensor, num_trigger_tokens: int, *,
                 causal: bool = True,
                 evaluation_fn: tp.Optional[AccuracyFn] = None,
                 token_filter: tp.Optional[np.ndarray] = None):
        self.model_fn = model_fn
        self.table = torch.as_tensor(embedding_table).detach()
        self.device = self.table.device
        self.L = num_trigger_tokens
        self.causal = causal
        self.evaluation_fn = evaluation_fn
        self.token_filter = (None if token_filter is None
                             else torch.as_tensor(token_filter, device=self.device))

    # -- primitives -----------------------------------------------------------

    def _splice(self, trigger_embs: torch.Tensor, batch: tp.Dict[str, torch.Tensor]
                ) -> torch.Tensor:
        """The k-th trigger embedding in each row's k-th trigger slot."""
        embs = self.table[batch["input_ids"]]
        mask = batch["trigger_mask"]
        slot = (mask.long().cumsum(dim=1) - 1).clamp(0, self.L - 1)
        return torch.where(mask[..., None], trigger_embs[slot], embs)

    def _predict_rows(self, embs: torch.Tensor, batch: tp.Dict[str, torch.Tensor]
                      ) -> torch.Tensor:
        """The logits at each row's predict position; ``embs`` may stack
        several tries of the same batch, (N B, T, D)."""
        logits = self.model_fn(embs)
        pos = batch["predict_mask"].long().argmax(dim=1)
        if self.causal:  # causal LM: position p is predicted at p - 1
            pos = (pos - 1).clamp(min=0)
        pos = pos.repeat(logits.shape[0] // pos.shape[0])
        return logits[torch.arange(logits.shape[0], device=logits.device), pos]

    def _grad_step(self, trigger_ids: torch.Tensor, batch: tp.Dict[str, torch.Tensor]
                   ) -> torch.Tensor:
        trigger_embs = self.table[trigger_ids].requires_grad_(True)
        with torch.enable_grad():
            pl = self._predict_rows(self._splice(trigger_embs, batch), batch)
            loss = label_loss(pl, batch["label_ids"]).mean()
            return torch.autograd.grad(loss, trigger_embs)[0]

    @torch.no_grad()
    def _eval_many(self, trials: torch.Tensor, batch: tp.Dict[str, torch.Tensor]) -> np.ndarray:
        """The metric summed over the batch for each trigger of ``trials``
        (N, L), all in one forward."""
        embs = torch.cat([self._splice(self.table[t], batch) for t in trials])
        rows = self._predict_rows(embs, batch)
        pl = rows.reshape(len(trials), -1, rows.shape[-1])
        labels = batch["label_ids"]
        if self.evaluation_fn is not None:
            scores = [self.evaluation_fn(p, labels).sum() for p in pl]
        else:
            scores = [(-label_loss(p, labels)).sum() for p in pl]
        return torch.stack(scores).cpu().numpy()

    # -- loop pieces ----------------------------------------------------------

    def _batches(self, examples: tp.Sequence[TriggerExample], bsz: int,
                 rng: tp.Optional[np.random.Generator] = None,
                 steps: tp.Optional[int] = None) -> tp.Iterator[tp.Dict[str, torch.Tensor]]:
        order = np.arange(len(examples))
        if rng is not None:
            rng.shuffle(order)
        starts = range(0, len(order) - bsz + 1, bsz) if len(order) >= bsz else []
        for i, s in enumerate(starts):
            if steps is not None and i >= steps:
                return
            yield {k: torch.from_numpy(v).to(self.device) for k, v in
                   collate([examples[j] for j in order[s:s + bsz]]).items()}

    def _ids(self, trigger: tp.Sequence[int]) -> torch.Tensor:
        return torch.as_tensor(np.asarray(trigger, np.int64), device=self.device)

    def evaluate(self, trigger_ids: tp.Sequence[int],
                 examples: tp.Sequence[TriggerExample], bsz: int = 32) -> float:
        """Dev-set metric of a trigger (reference dev-eval loop)."""
        if not examples:
            return 0.0
        tid = self._ids(trigger_ids)[None]
        num, den = 0.0, 0
        for batch in self._batches(examples, min(bsz, len(examples))):
            num += float(self._eval_many(tid, batch)[0])
            den += batch["input_ids"].shape[0]
        return num / (den + 1e-13)

    def search(self, train: tp.Sequence[TriggerExample],
               dev: tp.Sequence[TriggerExample], *,
               iters: int = 10, bsz: int = 8, accumulation_steps: int = 4,
               num_cand: int = 10, eval_size: int = 32,
               initial_trigger: tp.Optional[tp.Sequence[int]] = None,
               mask_id: int = 0, seed: int = 0,
               log_fn: tp.Optional[tp.Callable[[dict], None]] = None) -> dict:
        """Full search: per iteration, accumulate gradients over train batches,
        HotFlip one random slot, re-score candidates on fresh batches, accept
        if better, track the best trigger by dev metric."""
        if len(train) < bsz:
            raise ValueError(
                f"train set has {len(train)} usable examples < bsz {bsz} "
                "(rows that fail to templatize are skipped: check template/"
                "label_field/max_len)")
        if not dev:
            raise ValueError("dev set is empty after templatizing")
        rng = np.random.default_rng(seed)
        trigger = list(initial_trigger) if initial_trigger is not None else [mask_id] * self.L
        if len(trigger) != self.L:
            raise ValueError(f"the initial trigger has {len(trigger)} tokens, the template {self.L}")
        best = {"trigger_ids": list(trigger),
                "dev_metric": self.evaluate(trigger, dev, eval_size)}
        history = [dict(best, iter=-1)]

        for it in range(iters):
            tid = self._ids(trigger)
            # 1) averaged gradient over accumulation_steps fresh train batches
            avg_grad = None
            for batch in self._batches(train, bsz, rng, accumulation_steps):
                g = self._grad_step(tid, batch)
                avg_grad = g if avg_grad is None else avg_grad + g
            if avg_grad is None:
                break
            avg_grad = avg_grad / accumulation_steps

            # 2) HotFlip candidates for one random slot (minimize loss)
            slot = int(rng.integers(0, self.L))
            scores = -(self.table @ avg_grad[slot])
            if self.token_filter is not None:
                scores = scores + self.token_filter
            cands = torch.topk(scores, num_cand).indices.cpu().numpy()

            # 3) score current + all candidates on the SAME fresh batches, one
            # forward a batch (row 0 = current trigger)
            trials = np.tile(np.asarray(trigger, np.int64), (num_cand + 1, 1))
            trials[1:, slot] = cands
            trials_t = torch.as_tensor(trials, device=self.device)
            cur_score, cand_scores, den = 0.0, np.zeros(num_cand), 0
            for batch in self._batches(train, bsz, rng, accumulation_steps):
                scores_np = self._eval_many(trials_t, batch)
                cur_score += float(scores_np[0])
                cand_scores += scores_np[1:]
                den += batch["input_ids"].shape[0]

            accepted = bool(den) and bool((cand_scores > cur_score).any())
            rec = {"iter": it, "slot": slot, "accepted": accepted,
                   "train_metric": (max(cand_scores.max(initial=-np.inf), cur_score)
                                    / (den + 1e-13))}
            if accepted:
                trigger[slot] = int(cands[int(cand_scores.argmax())])
                rec["dev_metric"] = self.evaluate(trigger, dev, eval_size)
                rec["trigger_ids"] = list(trigger)
                if rec["dev_metric"] >= best["dev_metric"]:
                    best = {"trigger_ids": list(trigger), "dev_metric": rec["dev_metric"]}
            history.append(rec)
            if log_fn is not None:
                log_fn(rec)
        return {"best": best, "final_trigger_ids": list(trigger), "history": history}


def load_gpt2(name: str, checkpoint: tp.Optional[str], seed: int, device):
    """A GPT-2 of ``GPT2_CONFIGS[name]`` on ``device``: the tree of
    ``checkpoint`` (the JAX package's msgpack or the port's ``torch.save``),
    else weights drawn from ``seed``."""
    from summer_clip_torch.engine.checkpoint import load_pytree
    from summer_clip_torch.models import gpt2 as gpt2_mod

    cfg = gpt2_mod.GPT2_CONFIGS[name]
    if not checkpoint:
        model = gpt2_mod.GPT2(cfg, device=device)
        return model.init_weights(torch.Generator().manual_seed(int(seed))).eval(), cfg
    model = gpt2_mod.GPT2(cfg, device="meta").load_tree(load_pytree(checkpoint), device=device)
    left = [n for n, p in model.named_parameters() if p.is_meta]
    if left:
        raise ValueError(f"{checkpoint} lacks {len(left)} leaves of {name}: {left[:4]}")
    return model.eval(), cfg


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> dict:
    """Runnable trigger search over a GPT-2 family model + CLIP BPE tokenizer
    (the reference launches ``create_trigger`` through argparse; the same
    flags here, and ``--device``)."""
    import argparse

    from summer_clip_torch.core.device import resolve_device
    from summer_clip_torch.models.tokenizer import SimpleTokenizer

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--train", type=Path, required=True)
    p.add_argument("--dev", type=Path, required=True)
    p.add_argument("--template", required=True,
                   help='e.g. "[T] [T] [T] {sentence} [P]"')
    p.add_argument("--label-map", default=None,
                   help="json dict: label value -> label token string(s)")
    p.add_argument("--label-field", default="label")
    p.add_argument("--model", default="gpt2", help="GPT2_CONFIGS name")
    p.add_argument("--checkpoint", default=None,
                   help="the model's tree, msgpack or torch (random weights if absent)")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--bsz", type=int, default=8)
    p.add_argument("--accumulation-steps", type=int, default=4)
    p.add_argument("--num-cand", type=int, default=10)
    p.add_argument("--eval-size", type=int, default=32)
    p.add_argument("--max-len", type=int, default=64)
    p.add_argument("--initial-trigger", default=None,
                   help="space-separated initial trigger text (tokenized)")
    p.add_argument("--filter", action="store_true",
                   help="filter label/special/capitalized tokens from candidates")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=Path, default=None, help="results json path")
    p.add_argument("--device", default=None, help="default: the card; cpu for the CPU")
    args = p.parse_args(argv)

    tok = SimpleTokenizer()
    model, cfg = load_gpt2(args.model, args.checkpoint, args.seed, resolve_device(args.device))
    table = model.wte.embedding

    def encode(text: str) -> tp.List[int]:
        return [i % cfg.vocab_size for i in tok.encode(text)]

    label_map = json.loads(args.label_map) if args.label_map else None
    templatizer = Templatizer(args.template, encode, mask_id=0, label_map=label_map,
                              label_field=args.label_field, max_len=args.max_len)
    train = load_trigger_dataset(args.train, templatizer, limit=args.limit)
    dev = load_trigger_dataset(args.dev, templatizer)
    evaluation_fn = AccuracyFn.from_label_map(encode, label_map) if label_map else None
    token_filter = None
    if args.filter:
        label_rows = ([encode_label(encode, v) for v in label_map.values()]
                      if label_map else [e.label_ids for e in train])
        token_filter = build_token_filter(
            cfg.vocab_size, label_ids=label_rows, special_ids=[0],
            decode_fn=lambda ids: tok.decode(ids))

    def model_fn(inputs_embeds: torch.Tensor) -> torch.Tensor:
        return model(inputs_embeds=inputs_embeds)["logits"]

    searcher = TriggerSearch(model_fn, table, templatizer.num_trigger_tokens, causal=True,
                             evaluation_fn=evaluation_fn, token_filter=token_filter)
    initial = encode(args.initial_trigger) if args.initial_trigger else None
    result = searcher.search(
        train, dev, iters=args.iters, bsz=args.bsz,
        accumulation_steps=args.accumulation_steps, num_cand=args.num_cand,
        eval_size=args.eval_size, initial_trigger=initial, seed=args.seed,
        log_fn=lambda rec: print(json.dumps(rec)))
    result["best"]["trigger_text"] = tok.decode(result["best"]["trigger_ids"])
    print(json.dumps({"type": "best", **result["best"]}))
    if args.out:
        args.out.write_text(json.dumps(result, indent=2, default=float))
    return result


if __name__ == "__main__":
    main()
