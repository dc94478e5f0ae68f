"""summer_clip_torch apps."""
