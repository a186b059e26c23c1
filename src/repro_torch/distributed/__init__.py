"""Distribution: the sharding context, its collectives, the pipeline."""
