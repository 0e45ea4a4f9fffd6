"""Checkpointing policies: the Eq. 11-15 DP and the Young-Daly baseline."""
