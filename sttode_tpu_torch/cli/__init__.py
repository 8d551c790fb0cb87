"""Command-line entry points of the port: ``cli.train`` (stage-1 training)
and ``cli.test`` (evaluation of its checkpoints), for ETH-UCY, SDD and
NBA."""
