"""One driver a traffic kind: ``setup``, ``window``, ``end_to_end``,
``release`` and ``check`` (see ``run.run_cell``)."""
