"""One runner a traffic ``kind``: ``run(ctx) -> Outcome``."""
