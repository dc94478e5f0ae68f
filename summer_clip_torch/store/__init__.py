"""Feature store: catalogued, memory-mapped (N, emb_dim) arrays."""

from summer_clip_torch.store.feature_store import (  # noqa: F401
    FeatureStore, save_array, load_array, import_torch_features,
)
