"""Step-level glue shared by serving and (later) training."""
