"""The checkpointing pipeline: lifetime models, the DP solver, the
Monte-Carlo executor and the scenario sweep."""
