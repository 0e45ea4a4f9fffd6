"""Entry points: the trainer, the batch server and their step builders."""
