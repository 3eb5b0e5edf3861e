"""Process launchers: ``runner`` starts a job on the hosts of a hostfile
through ``launch`` (one process per node, with the rendezvous env; the
transports in ``multinode_runner``); ``serving_worker`` hosts one
``ServingEngine`` behind the serving RPC, and its ``WorkerSupervisor``
spawns and respawns such workers for a Router; ``http_gateway`` puts a
Router behind HTTP/SSE."""
