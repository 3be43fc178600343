"""The port's harnesses: the protocol fuzzer (:mod:`.proto_fuzz`), the
fault storm (:mod:`.chaos_run`), the join/leave/resize storm
(:mod:`.swarm_run`) and the CAVLC fuzzer (:mod:`.cavlc_fuzz`), each the
counterpart of the repository's ``tools/`` script of the same name, run
with ``python -m selkies_tpu_torch.tools.<name>``. Each takes ``--device``
(default: the card; ``cpu`` runs the plain PyTorch versions)."""
