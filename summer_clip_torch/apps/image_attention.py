"""CLIP-search / image-attention: the thesis method's evaluation grid.

Counterpart of ``summer_clip_tpu/apps/image_attention.py`` (rebuild of the
reference's ``summer_clip/clip_searcher/image_attention.py``): training-free,
label-free classification by attending test features over a cache of train
features with pseudo-label values, swept over a 4-deep strategy grid
(cache-selection x cache-weights x cache-values x alpha), each combination
logged as a machine-readable ``searcher_result`` record.

Execution, as in the JAX package:

- cache **selection** runs host-side (numpy: ragged index math, the same
  seeded generators, so both packages pick the same rows);
- the cache is **resident on the device**, pre-normalised and sorted by
  predicted class, so a selection is one device gather and Hard values are
  per-row labels for the label-driven kernels (K3 for class-grouped
  selections, K2 for scattered ones; the (N, C) one-hot matrix is never
  built), while Softmax values are computed on the device and go to the
  dense kernel K1;
- the betas of the weights strategy go through the kernels ``beta_chunk`` at a
  time, so the affinity is computed once per chunk;
- alpha blending + top-1/top-5 accuracy run on the device over the
  (beta-chunk x alpha) grid with ``label_rank``, sequentially over betas and
  alphas, so one (Nt, C) blend is live at a time;
- a weights strategy other than Tip-Adapter's takes the dense route: its own
  ``transform`` builds the (Nt, Nc) weights on the host and one f32 product
  with the values gives the cache logits (no cache kernel computes it).

Several cards, as in the JAX app: with more than one visible card
(``meta.world_size`` ranks when set) the cache's rows are split over the
ranks of a ``model`` axis (``setup_mesh``, one process a rank):
``parallel.ShardedResidentCache`` keeps each rank's rows resident and a
selection becomes a row mask, each rank runs K3 / K2 (Hard) or K1 (Softmax)
on its rows and one all-reduce adds the partial logits; values built on the
host go through ``parallel.sharded_cache_logits`` (K1 on each rank's rows).
Rank 0 logs the records and saves the arrays.

Spans and counters (:mod:`summer_clip_torch.core.profiling`): a pass is
``search.pass`` (counter ``search.passes``) around ``search.zero_shot``, each
selection's ``search.select``, each value strategy's ``search.values``, each
cache-logits call's ``search.cache`` (``search.cache_calls``), each chunk's
``search.evaluate`` with its host copy ``search.fetch`` (``search.points``:
the accuracies evaluated, one a value, beta and alpha) and each beta's
``search.log``.

Run: ``python -m summer_clip_torch.apps.image_attention dataset_name=<name>
data.features_key=<key> cache.features_key=<key> cache.outs_key=<key>``
(``img_attn_dataset@dataset_cfg=<dataset>`` composes a dataset's keys, as for
the JAX app).
"""

from __future__ import annotations

import typing as tp
from pathlib import Path

import numpy as np
import torch

from summer_clip_torch.apps.common import create_clip_session
from summer_clip_torch.apps.features_io import resolve_array
from summer_clip_torch.apps.savers import TensorsNumpySaver
from summer_clip_torch.core import config as C
from summer_clip_torch.core import profiling
from summer_clip_torch.engine.trainer import BaseTrainer, run_trainer, visible_world
from summer_clip_torch.methods import cache as cache_methods
from summer_clip_torch.methods.cache import cache_logits_for_betas
from summer_clip_torch.methods.zeroshot import compute_accuracy, label_rank, zeroshot_classifier
from summer_clip_torch.ops.cache_kernels import cache_attention_auto, cache_attention_from_labels
from summer_clip_torch.store import FeatureStore

ROW_PAD = 1024   # resident and gathered rows pad to this (zero value rows: exact)


def _one_hot(labels: np.ndarray, num_classes: int) -> np.ndarray:
    out = np.zeros((labels.shape[0], num_classes), np.float32)
    out[np.arange(labels.shape[0]), labels.astype(np.int64)] = 1.0
    return out


def _l2n(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def _pad_rows(x: np.ndarray, multiple: int = ROW_PAD) -> np.ndarray:
    pad = (-x.shape[0]) % multiple
    if not pad:
        return x
    return np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])


def _device_softmax_values(outs: torch.Tensor, valid: int, scale: float) -> torch.Tensor:
    """softmax(scale * outs) in f32 on the device, zeroed past ``valid`` (pad
    rows); bf16 on CUDA, the dense kernel's value operand."""
    v = torch.softmax(scale * outs.float(), dim=1)
    v = v * (torch.arange(outs.shape[0], device=outs.device) < valid)[:, None]
    return v.to(torch.bfloat16) if outs.is_cuda else v


class _ShardedValueSpec(tp.NamedTuple):
    """A value strategy computed on each rank from its resident outs
    (``parallel.ShardedResidentCache``) instead of on the host."""
    kind: str            # "hard" | "softmax"
    scale: float


class _OnehotValues(tp.NamedTuple):
    """Hard (one-hot) values represented by per-row labels only: they feed the
    label-driven kernels and the value matrix is never built. Produced from
    the prediction-sorted residence, so selections gather class-grouped rows."""
    labels: np.ndarray   # (valid,) int32 predicted class per selected row
    num_classes: int


class ImageAttention(BaseTrainer):
    # -- setup ---------------------------------------------------------------
    @classmethod
    def world_size(cls, cfg) -> int:
        """Every visible card when there is more than one (the JAX app's rule)."""
        return max(visible_world(cfg), 1)

    def setup_mesh(self):
        """The cache's rows split over every rank of the process group (one
        device without a group)."""
        from summer_clip_torch.parallel import model_mesh

        self.mesh = model_mesh()

    def setup_dataset(self):
        self.dataset = C.instantiate(self.cfg.dataset)
        self.test_labels = np.asarray(self.dataset.labels(), np.int32)
        self.cache_labels: tp.Optional[np.ndarray] = None
        if self.cfg.cache.get("dataset"):
            cache_view = C.instantiate(self.cfg.cache.dataset)
            self.cache_labels = np.asarray(cache_view.labels(), np.int32)
        if self.cfg.run_saves.save_labels and self.leads:
            self.save_labels()

    def setup_logger(self):
        super().setup_logger()
        self.gold_labels_saver = TensorsNumpySaver(Path("./gold_labels"))
        self.cache_saver = TensorsNumpySaver(Path("./cache_ids"))
        self.preds_saver = TensorsNumpySaver(Path("./preds_ids"))

    def save_labels(self) -> None:
        self.gold_labels_saver.save_named_tensor(self.test_labels, "test_labels")
        if self.cache_labels is not None:
            self.gold_labels_saver.save_named_tensor(self.cache_labels, "cache_labels")

    def setup_model(self):
        dev = self.device
        store = FeatureStore(self.cfg.store.root) if self.cfg.get("store") else None
        self.test_image_features = np.asarray(resolve_array(
            store, self.cfg.data.get("features_key"),
            self.cfg.data.get("image_features_path"), "features"), np.float32)

        session = create_clip_session(self.cfg.clip.model_name,
                                      self.cfg.clip.get("checkpoint_path"),
                                      self.cfg.clip.get("dtype"), device=dev,
                                      logger=self.logger, quant=self.cfg.clip.get("quant"))
        classes = self.cfg.prompting.classes or self.dataset.classes
        classifier = zeroshot_classifier(session.encode_text, classes,
                                         self.cfg.prompting.templates, device=dev)
        self._test_norm = torch.from_numpy(_l2n(self.test_image_features)).to(dev)
        self.clip_logits = 100.0 * self._test_norm @ classifier.t()

        self.origin_cache_image_features = np.asarray(resolve_array(
            store, self.cfg.cache.get("features_key"),
            self.cfg.cache.get("image_features_path"), "features"), np.float32)
        self.origin_cache_image_outs = np.array(resolve_array(
            store, self.cfg.cache.get("outs_key") or self.cfg.cache.get("features_key"),
            self.cfg.cache.get("image_outs_path"), "outs"), np.float32)
        self.logger.log_info(f"original-data-size: {self.origin_cache_image_outs.shape[0]}")

        # Device-resident, pre-normalised cache: a strategy's selection becomes
        # a device gather instead of a fresh upload of the (N, D) matrix per
        # combination. The outs are resident too, so Softmax values are
        # computed on the device. Rows are normalised in f32 first, so a bf16
        # residence only rounds the stored value.
        rd = str(self.cfg.cache.get("resident_dtype") or "float32")
        rdtype = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
                  "float32": torch.float32, "f32": torch.float32}[rd]
        self._cache_rows = self.origin_cache_image_features.shape[0]
        self._last_inds: tp.Optional[np.ndarray] = None
        self._outs_replaced = False
        self._sel_cache: tp.Optional[tp.Tuple[np.ndarray, tp.Any]] = None
        self._resident_shards = None
        if self.mesh is not None:
            from summer_clip_torch.parallel import ShardedResidentCache

            self._resident_shards = ShardedResidentCache(
                self.origin_cache_image_features, self.origin_cache_image_outs, self.mesh,
                axis="model", resident_dtype=rdtype)
            return
        # PREDICTION-SORTED residence: row order is irrelevant to every
        # combination (the cache logits are sums over rows), so the resident
        # matrices are grouped by predicted class. Selections map through
        # `_resident_rank` and gather class-grouped rows, which is what the
        # class-grouped one-hot kernel (K3) wants. Predictions come from the
        # outs as they will reside: with a bf16 residence a dense value path
        # would argmax the rounded outs, and tie rows must not flip class.
        outs_for_preds = torch.from_numpy(self.origin_cache_image_outs).to(rdtype).float().numpy()
        preds = outs_for_preds.argmax(axis=1).astype(np.int32)
        order = np.argsort(preds, kind="stable")
        self._resident_order = order              # sorted position -> original id
        self._resident_rank = np.empty_like(order)  # original id -> sorted position
        self._resident_rank[order] = np.arange(order.size)
        self._resident_preds = preds[order]       # predicted class per sorted row
        cn = _pad_rows(_l2n(self.origin_cache_image_features)[order])
        co = _pad_rows(self.origin_cache_image_outs[order])
        self._cache_dev = torch.from_numpy(cn).to(dev, rdtype)
        self._outs_dev = torch.from_numpy(co).to(dev, rdtype)

    # -- cache construction ----------------------------------------------------
    def build_cache(self, strategy, feats: np.ndarray, outs: np.ndarray
                    ) -> tp.Tuple[np.ndarray, np.ndarray, dict]:
        self._last_inds = None
        self._outs_replaced = False
        if not isinstance(strategy, cache_methods.IndexedCacheStrategy):
            cf, co = strategy.transform(feats, outs)
            return cf, co, {}
        inds = np.asarray(strategy.select(feats, outs))
        self._last_inds = inds
        cf, co = feats[inds], outs[inds]
        info: dict = {"cache_size": int(co.shape[0])}
        if self.cfg.run_saves.save_cache_inds and self.leads:
            info["cache_inds_path"] = str(self.cache_saver.save_tensor(inds))
        if self.cache_labels is not None:
            labels = self.cache_labels[inds]
            a1, a5 = compute_accuracy(co, labels)
            info.update(acc1=a1, acc5=a5)
            if self.cfg.cache.get("replace_outs_with_golds", False):
                co = _one_hot(labels, co.shape[1])
                self._outs_replaced = True
                a1, a5 = compute_accuracy(co, labels)
                info.update(acc1_replace=a1, acc5_replace=a5)
        return cf, co, info

    # -- grid ----------------------------------------------------------------
    def _grid_eval_fn(self) -> tp.Callable[[torch.Tensor], np.ndarray]:
        """(beta-chunk) x alpha accuracy evaluator on the device: (Bc, Nt, C)
        cache logits -> (Bc, A, 2) top-1 / top-5 in percent. Sequential over
        betas and alphas: one (Nt, C) blend is live at a time (a beta-batched
        blend would hold betas x alphas x Nt x C f32). Membership in the top
        k is sort-free (``label_rank``), exact including index tiebreaks. One
        host transfer per chunk."""
        labels = torch.from_numpy(self.test_labels.astype(np.int64)).to(self.device)
        clip_logits = self.clip_logits
        alphas = [float(a) for a in self.cfg.cache.alpha]
        k5 = min(5, int(clip_logits.shape[1]))

        def evaluate(cache_chunk: torch.Tensor) -> np.ndarray:
            with profiling.span("search.evaluate"):
                accs = []
                for cache_one in cache_chunk:
                    for alpha in alphas:
                        rank = label_rank(clip_logits + alpha * cache_one, labels)
                        accs.append(torch.stack([(rank == 0).float().mean() * 100.0,
                                                 (rank < k5).float().mean() * 100.0]))
                stacked = torch.stack(accs)
                with profiling.span("search.fetch"):
                    out = stacked.reshape(len(cache_chunk), len(alphas), 2).cpu().numpy()
                profiling.count("search.points", out.shape[0] * out.shape[1])
                return out

        return evaluate

    def _inject_context(self, strategy_cfg: dict) -> dict:
        """Fill label-dependent strategy params from the cache dataset."""
        cfg = dict(strategy_cfg)
        if "cache_labels" in cfg and cfg["cache_labels"] is None:
            if self.cache_labels is None:
                raise ValueError("strategy needs cache labels but no cache dataset configured")
            cfg["cache_labels"] = self.cache_labels
        return cfg

    def train_loop(self):
        with profiling.span("search.pass"):
            profiling.count("search.passes")
            with profiling.span("search.zero_shot"):
                a1, a5 = compute_accuracy(self.clip_logits, self.test_labels)
                zinfo: dict = {"acc1": a1, "acc5": a5}
                if self.cfg.run_saves.save_preds and self.leads:
                    preds = self.clip_logits.argmax(dim=1).cpu().numpy()
                    zinfo["preds_path"] = str(self.preds_saver.save_tensor(preds))
                if self.cfg.run_saves.save_logits and self.leads:
                    zinfo["logits_path"] = str(
                        self.preds_saver.save_tensor(self.clip_logits.cpu().numpy()))
                self.logger.log_info({**zinfo, "type": "zero_shot"})
            evaluate = self._grid_eval_fn()
            alphas = list(self.cfg.cache.alpha)
            weights_cfg = C.to_container(self.cfg.cache_weights_strategy, resolve=True)
            value_cfg = C.to_container(self.cfg.cache_value_strategy, resolve=True)

            for strategy_cfg in self.cfg.cache_strategies.values():
                raw_cfg = C.to_container(strategy_cfg, resolve=True)
                for strategy, strategy_params in C.instantiate_all(self._inject_context(raw_cfg)):
                    strategy_params = {k: v for k, v in strategy_params.items()
                                       if not isinstance(v, np.ndarray)}
                    with profiling.span("search.select"):
                        cf, co, cache_info = self.build_cache(
                            strategy, self.origin_cache_image_features,
                            self.origin_cache_image_outs)
                    self.logger.log_info({**cache_info, "cache_strategy": strategy_params,
                                          "type": "cache_info"})
                    self._sweep_weights_values(cf, co, strategy_params, weights_cfg,
                                               value_cfg, alphas, evaluate)


    def _selection_dev(self) -> tp.Optional[tp.Tuple[torch.Tensor, torch.Tensor, int]]:
        """(features, outs, valid_rows) of the current selection gathered from
        the resident cache in sorted-position order (class-grouped rows), rows
        padded to ``ROW_PAD``. The identity selection reuses the resident
        matrices as they are. Memoized per selection (keyed on the identity of
        the ``_last_inds`` array), so values and logits share one gather.
        ``_sel_perm`` maps gathered rows back to selection order (for value
        matrices built on the host), ``_sel_pos`` to sorted positions."""
        if self._last_inds is None:
            return None
        if self._sel_cache is None or self._sel_cache[0] is not self._last_inds:
            inds = self._last_inds
            identity = (len(inds) == self._cache_rows
                        and bool((inds == np.arange(self._cache_rows)).all()))
            if identity:
                self._sel_perm = self._resident_order
                self._sel_pos = None
                sel = (self._cache_dev, self._outs_dev, self._cache_rows)
            else:
                perm = np.argsort(self._resident_rank[inds], kind="stable")
                pos = self._resident_rank[inds][perm]
                self._sel_perm = perm
                self._sel_pos = pos
                pad = (-len(inds)) % ROW_PAD
                pos_p = np.concatenate([pos, np.zeros(pad, pos.dtype)]) if pad else pos
                pos_t = torch.from_numpy(pos_p.astype(np.int64)).to(self.device)
                sel = (self._cache_dev.index_select(0, pos_t),
                       self._outs_dev.index_select(0, pos_t), len(inds))
            self._sel_cache = (inds, sel)
        return self._sel_cache[1]

    def _device_values(self, value_strategy
                       ) -> tp.Union[torch.Tensor, _OnehotValues, _ShardedValueSpec, None]:
        """The value operand from the resident outs, padded in lockstep with
        the feature gather (pad rows carry zero values or label -1): labels
        for Hard values, a device matrix for Softmax values. None when the
        device path does not apply (non-indexed selection, outs replaced by
        golds, or another strategy); the caller then builds values on the host.
        On a mesh: a :class:`_ShardedValueSpec` that each rank computes from its
        resident outs."""
        if self._resident_shards is not None:
            if self._last_inds is None or self._outs_replaced:
                return None
            if isinstance(value_strategy, cache_methods.HardCacheStrategy):
                return _ShardedValueSpec("hard", 1.0)
            if isinstance(value_strategy, cache_methods.SoftmaxCacheStrategy):
                return _ShardedValueSpec("softmax", float(value_strategy.clip_scale)
                                         * float(value_strategy.scale))
            return None
        sel = None if self._outs_replaced else self._selection_dev()
        if sel is None:
            return None
        _, outs_sel, valid = sel
        if isinstance(value_strategy, cache_methods.HardCacheStrategy):
            labels = (self._resident_preds if self._sel_pos is None
                      else self._resident_preds[self._sel_pos])
            return _OnehotValues(labels, int(outs_sel.shape[1]))
        if isinstance(value_strategy, cache_methods.SoftmaxCacheStrategy):
            scale = float(value_strategy.clip_scale) * float(value_strategy.scale)
            return _device_softmax_values(outs_sel, valid, scale)
        return None

    def _fused_cache_logits(self, cache_features, values, betas) -> torch.Tensor:
        profiling.count("search.cache_calls")
        with profiling.span("search.cache"):
            if self.mesh is not None:
                if isinstance(values, _ShardedValueSpec):
                    # the resident ranks: the selection goes as a row mask
                    return self._resident_shards.logits(self._test_norm, self._last_inds,
                                                        list(betas), kind=values.kind,
                                                        scale=values.scale)
                from summer_clip_torch.parallel import sharded_cache_logits

                return sharded_cache_logits(self._test_norm,
                                            _l2n(np.asarray(cache_features, np.float32)),
                                            np.asarray(values), list(betas), self.mesh,
                                            axis="model")
            sel = self._selection_dev()
            if sel is None:
                return cache_logits_for_betas(self.test_image_features, cache_features,
                                              values, betas, device=self.device)
            cf_dev, _, valid = sel
            bet = torch.as_tensor(np.asarray(list(betas), np.float32)).to(self.device)
            if isinstance(values, _OnehotValues):
                # K3 for class-grouped selections, K2 for scattered ones: either
                # way the (N, C) value matrix never exists
                labels_p = np.full((cf_dev.shape[0],), -1, np.int32)
                labels_p[:valid] = values.labels
                return cache_attention_from_labels(self._test_norm, cf_dev, labels_p, bet,
                                                   values.num_classes)
            if not isinstance(values, torch.Tensor):
                # value matrix built on the host in selection order: bring it into
                # the gather's row order, pad, and keep int8 one-hots int8 on CUDA
                vals = _pad_rows(np.asarray(values)[self._sel_perm])
                as_int8 = np.issubdtype(vals.dtype, np.integer) and self.device.type == "cuda"
                values = torch.from_numpy(vals.astype(np.int8 if as_int8 else np.float32)
                                          ).to(self.device)
            if values.shape[0] != cf_dev.shape[0]:
                raise ValueError(f"values rows {values.shape[0]} != cache rows {cf_dev.shape[0]}")
            return cache_attention_auto(self._test_norm, cf_dev, values, bet)

    def _sweep_weights_values(self, cache_features, cache_outs, strategy_params,
                              weights_cfg, value_cfg, alphas, evaluate,
                              beta_chunk: int = 8):
        weights_list = list(C.instantiate_all(weights_cfg))
        all_tip = all(isinstance(w, cache_methods.TipAdapterWeightsStrategy)
                      for w, _ in weights_list)
        for value_strategy, value_params in C.instantiate_all(value_cfg):
            with profiling.span("search.values"):
                values = self._device_values(value_strategy) if all_tip else None
                if values is None:
                    values = value_strategy.transform(cache_outs)
            if not all_tip:
                # another weights strategy: the kernels compute
                # exp(-beta (1 - affinity)) and nothing else, so its weights
                # are built by its own transform and multiplied by the values
                # in the selection's own row order, as the JAX app does
                for w_strategy, wp in weights_list:
                    cache_logits = self._dense_cache_logits(
                        w_strategy.transform(self.test_image_features, cache_features), values)
                    self._log_results(strategy_params, wp, value_params, alphas,
                                      evaluate(cache_logits)[0], cache_logits[0])
                continue
            betas = [w.beta for w, _ in weights_list]
            for s in range(0, len(betas), beta_chunk):
                chunk = betas[s:s + beta_chunk]
                cache_logits = self._fused_cache_logits(cache_features, values, chunk)
                accs = evaluate(cache_logits)                     # (Bc, A, 2)
                for bi in range(len(chunk)):
                    self._log_results(strategy_params, weights_list[s + bi][1],
                                      value_params, alphas, accs[bi], cache_logits[bi])

    def _dense_cache_logits(self, weights: np.ndarray, values: np.ndarray) -> torch.Tensor:
        """(1, Nt, C) ``weights @ values`` in f32 on the device: the plain
        route of a weights strategy the cache kernels do not compute (the JAX
        app's dense fallback, which no Pallas kernel computes either)."""
        w = torch.from_numpy(np.asarray(weights, np.float32)).to(self.device)
        v = torch.from_numpy(np.asarray(values, np.float32)).to(self.device)
        return (w @ v)[None]

    def _log_results(self, strategy_params, weights_params, value_params,
                     alphas, accs: np.ndarray, cache_logits_one: torch.Tensor) -> None:
        if not self.leads:
            return
        with profiling.span("search.log"):
            for ai, alpha in enumerate(alphas):
                info: dict = {
                    "cache_strategy": strategy_params,
                    "cache_value_strategy": value_params,
                    "cache_weights_strategy": weights_params,
                    "alpha": float(alpha),
                    "acc1": float(accs[ai, 0]), "acc5": float(accs[ai, 1]),
                }
                if self.cfg.run_saves.save_preds:
                    preds = (self.clip_logits
                             + alpha * cache_logits_one).argmax(dim=1).cpu().numpy()
                    info["preds_path"] = str(self.preds_saver.save_tensor(preds))
                self.logger.log_info_wandb({**info, "type": "searcher_result"})


@C.main(config_path="../conf", config_name="image_attention")
def run(cfg):
    return run_trainer(ImageAttention, cfg)


if __name__ == "__main__":
    run()
