"""One module per traffic ``kind``: ``run(cell, ...) -> harness.Run``."""
