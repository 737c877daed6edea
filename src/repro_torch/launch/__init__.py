"""Entry points of the port: ``launch.serve`` (LM serving with hot weight
swap), ``launch.train`` (LM training), and the multi-process cluster
runtime (``launch.runtime``: one worker process per PS shard over
``launch.transport``, with ``launch.chaos`` fault plans) and its SLO
harness (``launch.slo``)."""
