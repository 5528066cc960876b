"""The port's op-level tools, run as ``python -m hplflownet_tpu_torch.tools.<name>``.

* ``timing``            the flagship's constants, the CUDA-event timer and
                        the card's ``nvidia-smi`` line;
* ``microbench``        every op of the flagship at its real shapes;
* ``gather_lab``        gather strategies at ``bcn1``'s table, and the
                        ``row_take`` kernel against ``index_select``;
* ``rank_partial_lab``  the ``rank_partial`` kernel's blocks-per-CTA sweep,
                        beside ``rank_reduce`` and ``blocked_rank_reduce``;
* ``rank_cases``        seeded edge-case streams for ``blocked_rank_reduce``
                        and ``rank_partial`` (a module, not a tool).

Each tool runs on the CUDA card unless given ``--device cpu`` (toy runs:
host clock, no device number) and prints one JSON line last.
"""
