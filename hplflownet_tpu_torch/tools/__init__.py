"""The port's op-level tools, run as ``python -m hplflownet_tpu_torch.tools.<name>``.

* ``timing``            the flagship's constants, the CUDA-event and
                        replayed-graph timers and the card's ``nvidia-smi``
                        line;
* ``microbench``        every op of the flagship at its real shapes;
* ``gather_lab``        gather strategies at ``bcn1``'s table, and the
                        ``row_take`` kernel against ``index_select``;
* ``rank_partial_lab``  the ``rank_partial`` kernel's blocks-per-CTA sweep,
                        beside ``rank_reduce`` and ``blocked_rank_reduce``;
* ``kernel_ab``         ``rank_reduce`` and ``stencil_tap_tables_sum``
                        against another tree's sources, on every input of
                        one train step, bit for bit and timed in turns;
* ``rank_cases``        seeded edge-case streams for ``rank_reduce``,
                        ``blocked_rank_reduce`` and ``rank_partial`` (a
                        module, not a tool);
* ``tap_cases``         seeded edge cases for ``stencil_tap_tables_sum`` (a
                        module);
* ``step_calls``        the calls one flagship forward and train step make
                        to those two kernels (a module);
* ``train_synthetic``   the learnability harness: a model trained on seeded
                        synthetic flow, its held-out EPE3D curve, the
                        parameters as a JAX-layout pickle;
* ``eval_synthetic``    such a pickle evaluated through ``train.driver``
                        (the six metrics, the scene dumps);
* ``dryrun_multiprocess``  a data-parallel step, or a lattice-sharded
                        forward, across fresh worker interpreters
                        (``parallel``), the ranks checked equal;
* ``large_cloud_bench`` 32768- and 98304-point pairs on one card: zero
                        overflow, ms/pair, peak memory;
* ``measure_capacities`` per-scale vertex counts on a config's dataset;
* ``pyramid_bench``     the lattice build's stages timed per scale;
* ``op_profile``        the top kernels of a forward or train step
                        (``torch.profiler``);
* ``port_torch_weights`` the reference's ``ours.pth.tar`` as a checkpoint
                        of the port.

Each tool runs on the CUDA card unless given ``--device cpu`` (toy runs:
host clock, no device number; ``kernel_ab`` needs a card) and prints one
JSON line last (``measure_capacities`` and ``port_torch_weights`` print
their result); none writes a file unless given one (``--out``, or
``port_torch_weights``' checkpoint directory).
"""
