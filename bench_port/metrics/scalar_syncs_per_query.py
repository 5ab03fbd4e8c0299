"""Pipeline executor and operators: device scalars read back to the host
(``executor.scalar_syncs``) per completed query of the window."""


def read(run):
    n = len(run.completed)
    return run.delta("executor.scalar_syncs") / n if n else None
