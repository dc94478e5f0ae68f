"""Research sandboxes: anomalous-token probing and universal-trigger search."""
