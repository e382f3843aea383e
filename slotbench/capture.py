"""What the check judges, kept as the timed path makes it.

Installed by the harness around the window of every run, from outside the
program, through the run's ``hooks.Hooks``: for each window frame, the
camera frontend's allowed region (mode 4), the object frontend's features
(host arrays the program already made), and the inputs and answer of the
last camera pose solve and of the last object pose solve (references to
tensors the program made); and the problem and answer of the window's last
camera BA. It adds no device work; its host cost is a few dictionary writes
a frame.
"""

from __future__ import annotations

import inspect


class Capture:
    def __init__(self, system, hooks):
        from pointslot_torch.solvers import local_ba, pose_opt

        self.frame = None            # the window frame in flight
        self.gates = {}
        self.obj_features = {}
        self.pose_lm, self.obj_lm = {}, {}
        self.ba_last = {}
        self._solver = None          # whose pose solve is running
        sig = inspect.signature(pose_opt.pose_optimize)

        def pose_optimize(lm):
            def wrapped(*args, **kwargs):
                res = lm(*args, **kwargs)
                if self.frame is not None and self._solver is not None:
                    self._solver[self.frame] = dict(sig.bind(*args, **kwargs).arguments, T=res.T)
                return res
            return wrapped

        def bundle_adjust(ba):
            def wrapped(prob, **kwargs):
                res = ba(prob, **kwargs)
                if self.frame is not None:
                    self.ba_last.update(prob=prob, res=res, cam=tuple(
                        float(kwargs[k]) for k in ("fx", "fy", "cx", "cy", "bf")))
                return res
            return wrapped

        hooks.wrap(pose_opt, "pose_optimize", pose_optimize)
        hooks.wrap(local_ba, "bundle_adjust", bundle_adjust)
        hooks.wrap(system.tracker, "_optimize_pose", lambda fn: self._solving(fn, self.pose_lm))
        hooks.wrap(system, "_background_gate", lambda fn: self._keeping(fn, self.gates))
        obj = system._object_system
        if obj is not None:
            hooks.wrap(obj, "_solve", lambda fn: self._solving(fn, self.obj_lm))
            hooks.wrap(obj, "_extract_object_features",
                       lambda fn: self._keeping(fn, self.obj_features))

    def _solving(self, fn, into):
        def wrapped(*args, **kwargs):
            self._solver = into
            try:
                return fn(*args, **kwargs)
            finally:
                self._solver = None
        return wrapped

    def _keeping(self, fn, into):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            if self.frame is not None:
                into[self.frame] = out
            return out
        return wrapped
