"""Files, forces and extra functions of ``ADFLOW`` (counterpart of the
solution output, restart, force and BC-data methods of
adflow_tpu/api/solver.py; reference pyADflow.writeSolution:2664,
getForces:3723, setBCVar through the BC-data subsystem, addFunction:1048).

The solver's state lives on its device. Every method here that writes a
file or returns an array moves what it needs to the host once, as float64
numpy, and computes the rest there as the JAX package does; the physics
(pressure, the viscous tractions, the residual) runs on the device. A
float32 state widened to float64 and written is read back exactly
(``_load_restart`` computes the conservative state in float64 and rounds
it once).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch

from adflow_torch.core.mesh import VISCOUS_WALL_BCS, BCType
from adflow_torch.core.refstate import GAMMA, PR_LAMINAR
from adflow_torch.physics.residual import build_topology, residual_list
from adflow_torch.physics.surface import (
    _patch_face_centers, cost_functions, flow_through, integrate_forces,
    wall_viscous_tractions)
from adflow_torch.physics.thermo import (
    laminar_viscosity, pressure, temperature)


def host64(t) -> np.ndarray:
    """A float64 numpy copy of a tensor (one device-to-host transfer)."""
    return t.detach().cpu().numpy().astype(np.float64, copy=False)


def to_numpy(a) -> np.ndarray:
    """A host numpy array of a tensor (as float64) or of an array."""
    return host64(a) if torch.is_tensor(a) else np.asarray(a)


class OutputMixin:
    """Solution files and restart, forces and heat fluxes, BC data, the
    slice, lift and force files, and the family and user functions."""

    _BCVAR_MAP = {
        "pressure": "P", "pressurestagnation": "Pt",
        "temperaturestagnation": "Tt", "temperature": "T",
        "density": "rho", "velocitymagnitude": "vmag",
        "velocityx": "vx", "velocityy": "vy", "velocityz": "vz",
        "velocitydir": "dir", "thrust": "thrust", "heat": "q",
    }

    # -- BC data (reference: BCData.F90:1403 setBCData) ------------------
    def setBCVar(self, varName: str, value, familyGroup: str):
        """Prescribe BC data on every subface of a family. ``value``: a
        scalar or a per-subface array over the subface's cell window (T1,
        T2). Units as in the JAX package: P/Pt/rho/vmag nondimensional, Tt
        over T_inf, wall 'Temperature' in Kelvin.

        Unlike the JAX package, this drops the Newton and adjoint
        functions (as ``setWallTemperature`` does): they captured the old
        topology, whose BC data the solve no longer uses."""
        key = self._BCVAR_MAP.get(varName.lower().replace(" ", ""))
        if key is None:
            raise ValueError(
                f"unknown BC variable '{varName}'; known: "
                f"{sorted(self._BCVAR_MAP)}")
        n = 0
        for b in self.mesh.blocks:
            for i, sf in enumerate(b.bcs):
                if sf.family == familyGroup:
                    data = dict(sf.data or {})
                    data[key] = (np.asarray(value)
                                 if np.ndim(value) > 0 else float(value))
                    b.bcs[i] = dataclasses.replace(sf, data=data)
                    n += 1
        if n == 0:
            raise ValueError(f"no BC subfaces in family '{familyGroup}'")
        # prescribed data is baked into the BC ops: rebuild
        self._rebuild_topology()

    def _rebuild_topology(self):
        self.topo = build_topology(self.mesh, cut_callback=self._cut_cb,
                                   dtype=self.dtype, device=self.device)
        self._nfns = None
        self._afns = None

    def getBCData(self, familyGroup: Optional[str] = None):
        """Current prescribed BC data {family: {key: value}}."""
        out = {}
        for b in self.mesh.blocks:
            for sf in b.bcs:
                if familyGroup is not None and sf.family != familyGroup:
                    continue
                if sf.data:
                    out.setdefault(sf.family, {}).update(sf.data)
        return out

    def setWallTemperature(self, temperature):
        """Prescribe isothermal-wall temperatures (reference
        setWallTemperature:3793): a scalar or {family: T}."""
        for blk in self.mesh.blocks:
            for sf in blk.bcs:
                if sf.bc is BCType.NS_WALL_ISOTHERMAL:
                    t = (temperature.get(sf.family)
                         if isinstance(temperature, dict) else temperature)
                    if t is not None:
                        d = dict(sf.data or {})
                        d["T"] = float(t)
                        object.__setattr__(sf, "data", d)
        self._rebuild_topology()

    # -- solution files and restart (reference: outputMod.F90:319-741) ---
    def _solution_dicts(self):
        """Per-block cell-centred solution dicts: the restart variables
        always, plus the ``volumeVariables`` menu. Each block's state (and
        residual, for the residual menu: one evaluation for all blocks)
        moves to the host once."""
        menu = [str(v).lower() for v in self.options["volumeVariables"]]
        wf = self._filled_w()
        res = None
        if "resrho" in menu or "resmom" in menu or "restot" in menu:
            res = residual_list(wf, self.metrics_list, self.topo, self.cfg,
                                self.ref, self.winf, self.extras_list)
        out = []
        for bi, w in enumerate(wf):
            wi = host64(w[2:-2, 2:-2, 2:-2])
            rho = wi[..., 0]
            vel = wi[..., 1:4] / rho[..., None]
            ke = 0.5 * np.sum(wi[..., 1:4] ** 2, axis=-1) / rho
            p = (GAMMA - 1.0) * (wi[..., 4] - ke)
            d = {"Density": rho, "VelocityX": vel[..., 0],
                 "VelocityY": vel[..., 1], "VelocityZ": vel[..., 2],
                 "Pressure": p,
                 "Mach": np.linalg.norm(vel, axis=-1) / np.sqrt(
                     GAMMA * p / rho),
                 "CoefPressure": (p - self.ref.p_inf) / max(self.ref.q_inf,
                                                            1e-30)}
            if self.cfg.n_turb == 1:
                d["TurbulentSANuTilde"] = wi[..., 5]
            elif self.cfg.n_turb == 2:
                d["TurbulentEnergyKinetic"] = wi[..., 5]
                d["TurbulentDissipationRate"] = wi[..., 6]
            if "temp" in menu:
                d["Temperature"] = GAMMA * p / rho
            if (("eddy" in menu or "eddyratio" in menu) and self.cfg.rans
                    and self.cfg.turbulence_model == "sa"):
                from adflow_torch.physics.sa import eddy_viscosity
                mu = laminar_viscosity(torch.from_numpy(GAMMA * p / rho),
                                       self.ref.mu_inf, self.ref.t_inf_dim)
                mut = eddy_viscosity(torch.from_numpy(wi), mu).numpy()
                mu = mu.numpy()
                if "eddy" in menu:
                    d["EddyViscosity"] = mut
                if "eddyratio" in menu:
                    d["RatioEddyViscosity"] = mut / np.maximum(mu, 1e-300)
            if "dist" in menu and self.extras_list is not None:
                dd = self.extras_list[bi].get("walldist")
                if dd is not None:
                    d["WallDistance"] = host64(dd)[1:-1, 1:-1, 1:-1]
            if "blank" in menu:
                ib = self.topo.blocks[bi].iblank
                if ib is not None:
                    d["Iblank"] = to_numpy(ib)[..., 0]
            if res is not None:
                rr = host64(res[bi])
                if "resrho" in menu:
                    d["ResidualDensity"] = rr[..., 0]
                if "resmom" in menu:
                    for c, nm in enumerate("XYZ"):
                        d[f"ResidualMomentum{nm}"] = rr[..., 1 + c]
                if "restot" in menu:
                    d["ResidualTotal"] = np.linalg.norm(rr, axis=-1)
            out.append(d)
        return out

    def writeVolumeSolutionFile(self, fileName: str, writeGrid: bool = True):
        """The volume solution as CGNS (io/cgns.py): HDF5 where h5py
        imports, else the ADF flavour."""
        from adflow_torch.io.cgns import write_cgns
        hist = None
        if self.options["storeConvHist"] and self.solve_info is not None:
            h = self.getConvergenceHistory()
            hist = {"RSDMassRMS": h["resrho"],
                    "RSDTurbulentRMS": h["resturb"]}
        write_cgns(self.mesh, fileName, solutions=self._solution_dicts(),
                   conv_hist=hist)

    def writeMeshFile(self, fileName: str):
        from adflow_torch.io.cgns import write_cgns
        write_cgns(self.mesh, fileName)

    def writeTecplotVolumeFile(self, fileName: str):
        """Tecplot ASCII volume file: one ORDERED (I,J,K, point-packed)
        zone per block with the coordinates and the cell-centred solution
        menu averaged to the nodes (reference output/tecplotIO.F90)."""
        sols = self._solution_dicts()
        with open(fileName, "w") as f:
            f.write('TITLE = "adflow_torch volume solution"\n')
            names = ["CoordinateX", "CoordinateY", "CoordinateZ"]
            names += list(sols[0].keys())
            f.write("VARIABLES = " + " ".join(f'"{n}"' for n in names)
                    + "\n")
            for bi, b in enumerate(self.mesh.blocks):
                ni, nj, nk = b.dims
                f.write(f'ZONE T="{b.name}" I={ni + 1} J={nj + 1} '
                        f'K={nk + 1} DATAPACKING=POINT\n')
                cols = [b.x[..., 0], b.x[..., 1], b.x[..., 2]]
                for c in sols[bi].values():
                    # cell -> node average (the edges replicate)
                    node = np.zeros((ni + 1, nj + 1, nk + 1))
                    wsum = np.zeros_like(node)
                    for di in (0, 1):
                        for dj in (0, 1):
                            for dk in (0, 1):
                                node[di:ni + di, dj:nj + dj,
                                     dk:nk + dk] += c
                                wsum[di:ni + di, dj:nj + dj,
                                     dk:nk + dk] += 1.0
                    cols.append(node / np.maximum(wsum, 1.0))
                flat = np.stack([np.asarray(c).reshape(-1, order="F")
                                 for c in cols], axis=1)
                np.savetxt(f, flat, fmt="%15.8g")

    def writeIsoSurfaceFile(self, fileName: str, isoSurfaces=None):
        """Triangulated isosurfaces of solution variables by marching
        tetrahedra on the node-averaged fields (io/isosurface.py).
        ``isoSurfaces``: {var: value}, else the ``isoSurface`` option."""
        from adflow_torch.io.isosurface import (
            _node_field, marching_tets, write_isosurface_tecplot)
        spec = (isoSurfaces if isoSurfaces is not None
                else self.options["isoSurface"])
        if not spec:
            raise ValueError("no isosurfaces requested (isoSurface option)")
        sols = self._solution_dicts()
        surfaces = []
        for var, value in spec.items():
            key = next((k for k in sols[0]
                        if k.lower() == str(var).lower()), None)
            if key is None:
                raise ValueError(
                    f"isoSurface variable '{var}' not in the volume "
                    f"menu {list(sols[0])}")
            tris = []
            for bi, b in enumerate(self.mesh.blocks):
                t = marching_tets(np.asarray(b.x),
                                  _node_field(sols[bi][key]), float(value))
                if len(t):
                    tris.append(t)
            tri = (np.concatenate(tris, axis=0) if tris
                   else np.zeros((0, 3, 3)))
            surfaces.append((f"{var}={value}", tri))
        write_isosurface_tecplot(fileName, surfaces)

    def writeSurfaceSensitivity(self, fileName: str, func: str,
                                groupName: Optional[str] = None):
        """Tecplot file of d(func)/d(surface node coordinates) over the
        wall patches (reference writeSurfaceSensitivity:2962), from
        ``evalFunctionsSens``: the volume-node derivative at the surface
        nodes (the frozen-warp surface sensitivity)."""
        sens = {}
        self.evalFunctionsSens(self.curAP, sens, evalFuncs=[func])
        dxv = np.asarray(
            sens[f"{self.curAP.name}_{func}"]["xv"]).reshape(-1, 3)
        ofs = 0
        dx_blocks = []
        for b in self.mesh.blocks:
            n = int(np.prod([d + 1 for d in b.dims]))
            dx_blocks.append(dxv[ofs:ofs + n].reshape(
                tuple(d + 1 for d in b.dims) + (3,)))
            ofs += n
        with open(fileName, "w") as f:
            f.write("Variables = CoordinateX CoordinateY CoordinateZ "
                    "dX dY dZ\n")
            for patch in self.wall_patches:
                if groupName is not None and patch.family != groupName:
                    continue
                xs = np.asarray(
                    self.mesh.blocks[patch.block].x[patch.fnode_sl])
                ds = dx_blocks[patch.block][patch.fnode_sl]
                n1, n2 = xs.shape[:2]
                f.write(f"ZONE Nodes={n1 * n2} Elements={(n1 - 1) * (n2 - 1)}"
                        " Zonetype=FEQuadrilateral Datapacking=Point\n")
                for p, d in zip(xs.reshape(-1, 3), ds.reshape(-1, 3)):
                    f.write("%15.8g %15.8g %15.8g %15.8g %15.8g %15.8g\n"
                            % (*p, *d))
                for i in range(n1 - 1):
                    for j in range(n2 - 1):
                        a = i * n2 + j + 1
                        f.write(f"{a} {a + 1} {a + n2 + 1} {a + n2}\n")

    def _face_pressure(self, wf, patch):
        """The wall-face pressure of a patch, the mean of its interior and
        ghost cells' (on the device)."""
        w = wf[patch.block]
        return 0.5 * (pressure(w[patch.int_sl]) + pressure(w[patch.ghost_sl]))

    def writeSurfaceSolutionFile(self, fileName: str):
        """Tecplot ASCII surface file: one zone per wall patch with the
        ``surfaceVariables`` menu (cp, v, mach, rho, p, temp, cf, yplus)."""
        menu = [str(v).lower() for v in self.options["surfaceVariables"]]
        wf = self._filled_w()
        visc_cache = {}
        names = ["Cp"]
        want_v = any(v in menu for v in ("vx", "vy", "vz"))
        if want_v:
            names += ["VelocityX", "VelocityY", "VelocityZ"]
        for key, name in (("mach", "Mach"), ("rho", "Density"),
                          ("p", "Pressure"), ("temp", "Temperature")):
            if key in menu:
                names.append(name)
        want_cf = any(v in menu for v in ("cf", "cfx", "cfy", "cfz",
                                          "yplus")) and self.cfg.viscous
        if want_cf:
            names += ["Cf", "CfX", "CfY", "CfZ", "YPlus"]
        with open(fileName, "w") as f:
            f.write('TITLE = "adflow_torch surface solution"\n')
            f.write('VARIABLES = "X" "Y" "Z" '
                    + " ".join(f'"{n}"' for n in names) + "\n")
            nvar = 3 + len(names)
            cellvars = ",".join(str(i) for i in range(4, nvar + 1))
            for pi, patch in enumerate(self.wall_patches):
                x = host64(self.x_list[patch.block][patch.fnode_sl])
                w = wf[patch.block]
                m = self.metrics_list[patch.block]
                wi = host64(w[patch.int_sl])
                wg = host64(w[patch.ghost_sl])
                p_face = host64(self._face_pressure(wf, patch))
                cols = [(p_face - self.ref.p_inf)
                        / max(self.ref.q_inf, 1e-30)]
                vel = wi[..., 1:4] / wi[..., 0:1]
                if want_v:
                    cols += [vel[..., 0], vel[..., 1], vel[..., 2]]
                if "mach" in menu:
                    cols.append(np.linalg.norm(vel, axis=-1)
                                / np.sqrt(GAMMA * p_face / wi[..., 0]))
                if "rho" in menu:
                    cols.append(0.5 * (wi[..., 0] + wg[..., 0]))
                if "p" in menu:
                    cols.append(p_face)
                if "temp" in menu:
                    cols.append(GAMMA * p_face / (0.5 * (wi[..., 0]
                                                       + wg[..., 0])))
                if want_cf:
                    cols += self._skin_friction(w, m, patch, wi, visc_cache)
                n1, n2 = x.shape[:2]
                f.write(f'ZONE T="patch{pi}" I={n1} J={n2} '
                        f'DATAPACKING=BLOCK, '
                        f'VARLOCATION=([{cellvars}]=CELLCENTERED)\n')
                for dcomp in range(3):
                    np.savetxt(f, x[..., dcomp].T.reshape(-1)[None],
                               fmt="%.12e")
                for c in cols:
                    np.savetxt(f, np.asarray(c).T.reshape(-1)[None],
                               fmt="%.12e")

    def _skin_friction(self, w, m, patch, wi, visc_cache):
        """Cf, CfX, CfY, CfZ and y+ of a wall patch's faces (host)."""
        s_ = (m.si, m.sj, m.sk)[patch.axis]
        da = np.linalg.norm(host64(s_[patch.face_sl]), axis=-1)
        qs = max(0.5 * self.ref.mach ** 2, 1e-30)
        if patch.bc in VISCOUS_WALL_BCS:
            ex = self.extras_list[patch.block] if self.extras_list else None
            df = host64(wall_viscous_tractions(
                w, m, self.cfg, self.ref, patch, extras=ex,
                cache=visc_cache))
            tau = df / np.maximum(da, 1e-300)[..., None]
            taumag = np.linalg.norm(tau, axis=-1)
        else:
            tau = np.zeros(da.shape + (3,))
            taumag = np.zeros_like(da)
        # y+ = d1 utau / nu with utau = sqrt(tau_w / rho)
        t_i = torch.from_numpy(GAMMA * host64(pressure(w[patch.int_sl]))
                               / wi[..., 0])
        mu = laminar_viscosity(t_i, self.ref.mu_inf,
                               self.ref.t_inf_dim).numpy()
        vol1 = host64(m.vol[patch.int_sl])
        d1 = 0.5 * vol1 / np.maximum(da, 1e-300)
        utau = np.sqrt(np.maximum(taumag, 0.0) / wi[..., 0])
        return [taumag / qs, tau[..., 0] / qs, tau[..., 1] / qs,
                tau[..., 2] / qs,
                d1 * utau * wi[..., 0] / np.maximum(mu, 1e-300)]

    def writeSolution(self, outputDir: Optional[str] = None,
                      baseName: Optional[str] = None, number=None):
        """Write the volume, surface and lift-distribution files (reference
        writeSolution:2664; numberSolutions appends the per-problem call
        counter padded to writeSolutionDigits digits)."""
        outputDir = outputDir or self.options["outputDirectory"]
        baseName = baseName or (self.curAP.name if self.curAP else "sol")
        digits = max(int(self.options["writeSolutionDigits"]), 1)
        if number is None and bool(self.options["numberSolutions"]):
            number = self._sol_counter.get(baseName, 0)
            self._sol_counter[baseName] = number + 1
        if number is not None:
            baseName = f"{baseName}_{int(number):0{digits}d}"
        base = os.path.join(outputDir, baseName)
        self.writeVolumeSolutionFile(base + "_vol.cgns")
        self.writeSurfaceSolutionFile(base + "_surf.dat")
        if self._lift_dists:
            self.writeLiftDistributionFile(base + "_lift.dat")

    def _load_restart(self):
        """Read the ``restartFile`` CGNS solution into the state (reference
        variableReading.F90): the conservative state in float64 on the
        host, each block sent to the device once in the solver's dtype."""
        from adflow_torch.io.cgns import read_cgns_solution
        sols = read_cgns_solution(self.options["restartFile"])
        winf = np.asarray(self.ref.winf(), np.float64)
        w_list = []
        for bi, b in enumerate(self.mesh.blocks):
            d = sols[bi]
            rho = np.asarray(d["Density"], np.float64)
            vel = np.stack([np.asarray(d[f"Velocity{c}"], np.float64)
                            for c in "XYZ"], axis=-1)
            p = np.asarray(d["Pressure"], np.float64)
            rhoe = p / 0.4 + 0.5 * rho * np.sum(vel * vel, axis=-1)
            cols = [rho[..., None], rho[..., None] * vel, rhoe[..., None]]
            turb = (("TurbulentSANuTilde",) if self.cfg.n_turb == 1 else
                    ("TurbulentEnergyKinetic", "TurbulentDissipationRate")
                    if self.cfg.n_turb == 2 else ())
            for j, nm in enumerate(turb):
                v = (np.asarray(d[nm], np.float64) if nm in d
                     else np.full_like(rho, winf[5 + j]))
                cols.append(v[..., None])
            w = np.empty(tuple(dd + 4 for dd in b.dims) + (self.ref.nw,))
            w[...] = winf
            w[2:-2, 2:-2, 2:-2] = np.concatenate(cols, axis=-1)
            w_list.append(torch.as_tensor(w, dtype=self.dtype,
                                          device=self.device))
        self.w_list = w_list

    def getConvergenceHistory(self):
        """Reference getConvergenceHistory:1404."""
        if self.solve_info is None:
            return {}
        h = self.solve_info.history
        return {"resrho": h[:, 0], "resturb": h[:, 1],
                "iterations": np.arange(len(h))}

    # -- forces (reference: getForces.F90:2, getHeatFluxes:3755) ---------
    def getForces(self, groupName: Optional[str] = None):
        """Nodal wall forces in Newtons, (n, 3) numpy: the pressure and
        viscous force of each face, a quarter to each of its nodes."""
        wf = self._filled_w()
        out = []
        visc_cache = {}
        for patch in self.wall_patches:
            w = wf[patch.block]
            m = self.metrics_list[patch.block]
            s = (m.si, m.sj, m.sk)[patch.axis]
            df = ((self._face_pressure(wf, patch) - self.ref.p_inf)[..., None]
                  * (patch.sign * s[patch.face_sl]))
            if patch.bc in VISCOUS_WALL_BCS and self.cfg.viscous:
                ex = (self.extras_list[patch.block]
                      if self.extras_list is not None else None)
                df = df + wall_viscous_tractions(
                    w, m, self.cfg, self.ref, patch, extras=ex,
                    cache=visc_cache)
            df = host64(df)
            n1, n2 = df.shape[0] + 1, df.shape[1] + 1
            nodal = np.zeros((n1, n2, 3))
            for di in (0, 1):
                for dj in (0, 1):
                    nodal[di:n1 - 1 + di, dj:n2 - 1 + dj] += 0.25 * df
            out.append(nodal.reshape(-1, 3) * self.ref.p_ref_dim)
        return np.concatenate(out) if out else np.zeros((0, 3))

    def getHeatFluxes(self, groupName: Optional[str] = None):
        """Wall heat flux per wall face, q = k dT/dn times the face area
        (thin-layer wall gradient), flat numpy."""
        wf = self._filled_w()
        out = []
        for patch in self.wall_patches:
            w = wf[patch.block]
            m = self.metrics_list[patch.block]
            s = (m.si, m.sj, m.sk)[patch.axis]
            smag = torch.linalg.norm(s[patch.face_sl], dim=-1)
            ti = temperature(w[patch.int_sl])
            tg = temperature(w[patch.ghost_sl])
            mu = laminar_viscosity(0.5 * (ti + tg), self.ref.mu_inf,
                                   self.ref.t_inf_dim)
            k = mu / (PR_LAMINAR * (GAMMA - 1.0))
            dn = m.vol[patch.int_sl] / torch.clamp(smag, min=1e-30)
            q = k * (ti - tg) / torch.clamp(dn, min=1e-30)
            out.append(host64(q * smag).reshape(-1))
        return np.concatenate(out) if out else np.zeros(0)

    def writeForceFile(self, fileName: str, groupName: Optional[str] = None):
        """Nodal wall force file (reference writeForceFile:2884)."""
        pts = self.getSurfaceCoordinates(groupName)
        forces = self.getForces(groupName)
        with open(fileName, "w") as f:
            f.write(f"{len(pts)}\n")
            for p, fr in zip(pts, forces.reshape(-1, 3)):
                f.write(" ".join(f"{v:.12e}" for v in (*p, *fr)) + "\n")

    # -- lift distributions and slices (reference: addLiftDistribution:470,
    # addSlices:516, tecplotIO.F90) --------------------------------------
    def addLiftDistribution(self, nSegments: int, direction: str,
                            groupName: Optional[str] = None):
        """A spanwise lift distribution, written by ``writeSolution``."""
        idx = {"x": 0, "y": 1, "z": 2}[direction.lower()]
        self._lift_dists.append((int(nSegments), idx))

    def writeLiftDistributionFile(self, fileName: str):
        """The wall-face pressure forces binned along each distribution's
        axis: sectional lift and drag per unit span."""
        wf = self._filled_w()
        with open(fileName, "w") as f:
            f.write('TITLE = "lift distribution"\n')
            f.write('VARIABLES = "coor" "lift" "drag"\n')
            for nseg, axd in self._lift_dists:
                lo, hi = np.inf, -np.inf
                data = []
                for patch in self.wall_patches:
                    m = self.metrics_list[patch.block]
                    s = (m.si, m.sj, m.sk)[patch.axis]
                    df = host64(
                        (self._face_pressure(wf, patch)
                         - self.ref.p_inf)[..., None]
                        * (patch.sign * s[patch.face_sl]))
                    c = host64(_patch_face_centers(
                        self.x_list[patch.block], patch))[..., axd]
                    c = c.reshape(-1)
                    lo, hi = min(lo, c.min()), max(hi, c.max())
                    data.append((c, df.reshape(-1, 3)))
                if not data:
                    continue
                if hi - lo < 1e-10:   # quasi-2D: one band of unit width
                    lo, hi = lo - 0.5, lo + 0.5
                edges = np.linspace(lo, hi + 1e-12, nseg + 1)
                lift = np.zeros(nseg)
                drag = np.zeros(nseg)
                for c, df in data:
                    bins = np.clip(np.digitize(c, edges) - 1, 0, nseg - 1)
                    np.add.at(lift, bins, self.ref.p_ref_dim
                              * (df @ np.asarray(self.ref.lift_dir)))
                    np.add.at(drag, bins, self.ref.p_ref_dim
                              * (df @ np.asarray(self.ref.drag_dir)))
                centers = 0.5 * (edges[:-1] + edges[1:])
                width = edges[1] - edges[0]
                f.write(f'ZONE T="dist_{"xyz"[axd]}" I={nseg}\n')
                for i in range(nseg):
                    f.write(f"{centers[i]:.10e} {lift[i] / width:.10e} "
                            f"{drag[i] / width:.10e}\n")

    def addSlices(self, direction: str, positions, sliceType: str = "relative",
                  groupName: Optional[str] = None):
        """Plane cuts of the wall surface normal to ``direction`` ('x',
        'y' or 'z') at ``positions``."""
        ax = {"x": 0, "y": 1, "z": 2}[direction.lower()]
        for pos in np.atleast_1d(positions):
            self._slices.append((ax, float(pos)))

    def _surface_cp(self, patch, wf=None):
        """Cp of a wall patch's faces, host numpy."""
        wf = self._filled_w() if wf is None else wf
        qinf = 0.5 * self.ref.mach ** 2
        return host64((self._face_pressure(wf, patch) - self.ref.p_inf)
                      / qinf)

    def writeSlicesFile(self, fileName: str):
        """All slices as Tecplot FELINESEG zones with Cp."""
        from adflow_torch.io.slices import slice_quads, write_tecplot_slices
        wf = self._filled_w() if self._slices else None
        out = []
        for ax, pos in self._slices:
            nrm = np.zeros(3)
            nrm[ax] = 1.0
            segs_all, cps = [], []
            for patch in self.wall_patches:
                corners = host64(self.x_list[patch.block][patch.fnode_sl])
                segs, vals = slice_quads(
                    corners, {"Cp": self._surface_cp(patch, wf)}, nrm * pos,
                    nrm)
                if len(segs):
                    segs_all.append(segs)
                    cps.append(vals["Cp"])
            if segs_all:
                out.append((f"slice_{'xyz'[ax]}_{pos:g}",
                            np.concatenate(segs_all),
                            {"Cp": np.concatenate(cps)}))
        write_tecplot_slices(fileName, out)

    # -- family and user functions (reference: addUserFunction:1005,
    # addFunction:1048) --------------------------------------------------
    def addFunction(self, funcName: str, groupName: Optional[str],
                    name: Optional[str] = None):
        """Register ``funcName`` restricted to a surface family; returns
        its name (``<funcName>_<groupName>`` unless given)."""
        name = name or f"{funcName}_{groupName}"
        self._extra_funcs[name.lower()] = ("family", funcName.lower(),
                                           groupName)
        return name

    def addUserFunction(self, funcName: str, functions: Sequence[str],
                        callback):
        """Register a Python composite of existing cost functions."""
        self._extra_funcs[funcName.lower()] = ("user", list(functions),
                                               callback)
        return funcName

    def _eval_extra_funcs(self, base: dict) -> dict:
        out = {}
        wf = None
        for name, spec in self._extra_funcs.items():
            if spec[0] == "user":
                _, deps, cb = spec
                out[name] = float(cb({d: base[d.lower()] for d in deps}))
                continue
            _, fname, group = spec
            if wf is None:
                wf = self._filled_w()
            patches = [p for p in self.wall_patches
                       if group is None or p.family == group]
            f = integrate_forces(wf, self.x_list, self.metrics_list,
                                 patches, self.ref, self.cfg,
                                 iblank_list=self._iblank_list(),
                                 extras_list=self.extras_list)
            # family-restricted flow-through functions (mdot, aavgptot,
            # ... on an inflow or outflow family)
            fpatches = [p for p in self.flow_patches
                        if group is None or p.family == group]
            if fpatches:
                f.update(flow_through(wf, self.metrics_list, fpatches,
                                      self.ref))
            out[name] = float(cost_functions(f, self.ref)[fname])
        return out

    def mapVector(self, vec, groupName1: Optional[str],
                  groupName2: Optional[str], vec2=None):
        """Map a surface-node vector between family groups (reference
        mapVector:5045); numpy in and out. ``vec2``, if given, receives
        the result in place (a numpy array or a tensor)."""
        vec = to_numpy(vec)
        sizes = [int(np.prod(self.x_list[p.block][p.fnode_sl].shape[:-1]))
                 for p in self.wall_patches]
        ofs = np.concatenate([[0], np.cumsum(sizes)]).astype(int)

        def rows(group):
            return np.concatenate(
                [np.arange(ofs[i], ofs[i + 1])
                 for i, p in enumerate(self.wall_patches)
                 if group is None or p.family == group]
                + [np.zeros(0, int)])

        full = np.zeros((int(ofs[-1]), vec.shape[-1]))
        full[rows(groupName1)] = vec
        out = full[rows(groupName2)]
        if torch.is_tensor(vec2):
            vec2.copy_(torch.as_tensor(out))
        elif vec2 is not None:
            np.asarray(vec2)[...] = out
        return out
