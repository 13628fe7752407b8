"""Training: CDN queries, the matcher, the criterion, the optimiser and EMA,
and the Trainer."""
