"""Data-parallel training across processes, one rank per card
(``distributed`` for the process group, ``mesh`` for the data-parallel value
and its helpers, ``multihost_dryrun`` for a localhost launcher and drills)."""
