"""Parameter-server core of the port: hash map, routing, sparse tables,
master and slave shards, replica sets, the train→serve transform, the
queue and the sync stream, the feature filter and the monitors."""
