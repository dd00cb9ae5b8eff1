"""Device ms of one ICP iteration: the ``icp_solve`` span of ``PhaseTimer``
(CUDA events around the solve graph's copy-in, replay and copy-out, without
the reading filters or the merge decision's read) over the iterations the
Mapper harvested (``count.icp_iterations``)."""


def read(ctx):
    ms = ctx.phases_ms
    iterations = ms.get("count.icp_iterations")
    if "icp_solve" not in ms or not iterations:
        return None
    return ms["icp_solve"] / iterations
