"""Entry points of the serving path: step builders and the batch server."""
