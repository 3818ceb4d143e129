"""One-off readings on the card that set or justify the benchmark's choices."""
