"""Process launchers: ``serving_worker`` hosts one ``ServingEngine`` behind
the serving RPC, and its ``WorkerSupervisor`` spawns and respawns such
workers for a Router."""
