"""Per-example norm machinery: estimators, taps, plans and the engine."""
