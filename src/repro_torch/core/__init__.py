"""Parameter-server core of the port: hash map, routing, sparse tables,
slave shards, replica sets and the latency monitor's percentile ring."""
