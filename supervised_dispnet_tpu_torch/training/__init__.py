"""Train and eval steps, and the epoch-level trainer."""
