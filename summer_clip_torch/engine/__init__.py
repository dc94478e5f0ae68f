"""summer_clip_torch engine."""
