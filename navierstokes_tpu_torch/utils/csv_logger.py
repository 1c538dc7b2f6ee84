"""forces_vs_time.csv writer with the reference's exact column schema.

Header parity: ``time,deltat,GMRES_iters,time_prec_init,time_sol,Drag,Lift,
Cd,Cl`` (reference: src/NavierStokes.cpp:446-447, rows at :484-488).
``time_prec_init`` is the block-Jacobi tile rebuild of the step and
``time_sol`` the rest of its wall-clock time.
"""

from __future__ import annotations


class ForcesCsv:
    HEADER = ("time,deltat,GMRES_iters,time_prec_init,time_sol,"
              "Drag,Lift,Cd,Cl\n")

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "w")
        self._f.write(self.HEADER)

    def row(self, time, deltat, iters, t_prec, t_sol, drag, lift, cd, cl):
        self._f.write(f"{time},{deltat},{int(iters)},{t_prec},{t_sol},"
                      f"{drag},{lift},{cd},{cl}\n")
        self._f.flush()

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
