"""MJCF (MuJoCo XML) scene loader for the v2 engine.

Counterpart of `brax_tpu/v2/mjcf.py`, for what the v2 asset scenes use:
the ElementTree parse, <default> attributes, fusing of jointless bodies
into their parent, free / hinge / slide joints (1-3 hinges or slides
stacked on one body), sphere / capsule / plane geoms with inertia from the
geoms (or explicit <inertial>), <motor> actuators, <contact> <pair>s under
collision="predefined" (else every eligible pair), <custom> parameters, and
the inverse weights (`_compute_invweight`) from the port's own pipeline.
Ball joints, box / mesh / convex / heightfield geoms and <position>
actuators raise NotImplementedError.

The scene is compiled in float64 numpy, as the JAX package does, and handed
to torch as float32.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional
from xml.etree import ElementTree

import numpy as np
import torch

from brax_torch.v2.base import Capsule, Plane, Sphere, System

_COLLIDABLES = [
    ((Sphere, False), (Plane, True)),
    ((Sphere, False), (Sphere, False)),
    ((Sphere, False), (Capsule, False)),
    ((Capsule, False), (Plane, True)),
    ((Capsule, False), (Capsule, False)),
]


def _arr(s: str, n: Optional[int] = None) -> np.ndarray:
    a = np.array([float(x) for x in s.split()])
    if n is not None and a.shape[0] != n:
        raise ValueError(f"expected {n} values, got {a.shape[0]}: {s!r}")
    return a


def _euler_to_quat_deg(v: np.ndarray, degrees: bool) -> np.ndarray:
    """MuJoCo default eulerseq 'xyz' (extrinsic x-y-z)."""
    if degrees:
        v = v * np.pi / 180.0
    c, s = np.cos(v / 2), np.sin(v / 2)
    # extrinsic xyz == intrinsic z-y'-x'' reversed; compose q = qz*qy*qx? no:
    # extrinsic rotations about fixed axes x, then y, then z: q = qz qy qx
    qx = np.array([c[0], s[0], 0, 0])
    qy = np.array([c[1], 0, s[1], 0])
    qz = np.array([c[2], 0, 0, s[2]])
    return _quat_mul(_quat_mul(qz, qy), qx)


def _quat_mul(u, v):
    return np.array(
        [
            u[0] * v[0] - u[1] * v[1] - u[2] * v[2] - u[3] * v[3],
            u[0] * v[1] + u[1] * v[0] + u[2] * v[3] - u[3] * v[2],
            u[0] * v[2] - u[1] * v[3] + u[2] * v[0] + u[3] * v[1],
            u[0] * v[3] + u[1] * v[2] - u[2] * v[1] + u[3] * v[0],
        ]
    )


def _quat_rotate(v, q):
    s, u = q[0], q[1:]
    return 2 * (u @ v) * u + (s * s - u @ u) * v + 2 * s * np.cross(u, v)


def _quat_to_mat(q):
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _z_to_vec_quat(vec: np.ndarray) -> np.ndarray:
    """Quaternion rotating +z onto vec (for fromto geom frames)."""
    z = np.array([0.0, 0.0, 1.0])
    v = vec / np.linalg.norm(vec)
    d = z @ v
    if d > 1 - 1e-9:
        return np.array([1.0, 0.0, 0.0, 0.0])
    if d < -1 + 1e-9:
        return np.array([0.0, 1.0, 0.0, 0.0])  # pi about x
    axis = np.cross(z, v)
    axis /= np.linalg.norm(axis)
    half = np.arccos(np.clip(d, -1, 1)) / 2
    return np.concatenate([[np.cos(half)], axis * np.sin(half)])


def _axisangle_to_quat(v: np.ndarray, degrees: bool) -> np.ndarray:
    axis, angle = v[:3], v[3]
    if degrees:
        angle = angle * np.pi / 180.0
    axis = axis / np.linalg.norm(axis)
    return np.concatenate([[np.cos(angle / 2)], axis * np.sin(angle / 2)])


def _frame_quat(elem, degrees: bool) -> np.ndarray:
    if "quat" in elem.attrib:
        q = _arr(elem.attrib["quat"], 4)
        return q / np.linalg.norm(q)
    if "euler" in elem.attrib:
        return _euler_to_quat_deg(_arr(elem.attrib["euler"], 3), degrees)
    if "axisangle" in elem.attrib:
        return _axisangle_to_quat(_arr(elem.attrib["axisangle"], 4), degrees)
    return np.array([1.0, 0.0, 0.0, 0.0])


def _sphere_mass_inertia(r: float, density: float, mass: Optional[float]):
    vol = 4.0 / 3.0 * np.pi * r**3
    m = mass if mass is not None else density * vol
    i = 2.0 / 5.0 * m * r * r
    return m, np.diag([i, i, i]), np.zeros(3)


def _capsule_mass_inertia(r: float, half_len: float, density: float, mass):
    """Cylinder of length 2*half_len plus two hemispherical caps."""
    length = 2 * half_len
    vol_c = np.pi * r * r * length
    vol_s = 4.0 / 3.0 * np.pi * r**3
    vol = vol_c + vol_s
    density = (mass / vol) if mass is not None else density
    mc, ms = density * vol_c, density * vol_s
    izz = mc * r * r / 2.0 + ms * 2.0 * r * r / 5.0
    ixx = (
        mc * (3 * r * r + length * length) / 12.0
        + ms * (2.0 * r * r / 5.0 + half_len * half_len + 3.0 * half_len * r / 8.0 * 2)
    )
    m = mc + ms
    return m, np.diag([ixx, ixx, izz]), np.zeros(3)


def _fuse_bodies(elem: ElementTree.Element):
    """Merges child bodies without joints into their parent (offsetting pos)."""
    for child in list(elem):
        if child.tag == "body" and "joint" not in [e.tag for e in child]:
            cpos = _arr(child.attrib.get("pos", "0 0 0"), 3)
            for grandchild in child:
                if grandchild.tag in ("body", "geom") and (cpos != 0).any():
                    gpos = _arr(grandchild.attrib.get("pos", "0 0 0"), 3) + cpos
                    grandchild.attrib["pos"] = " ".join("%f" % x for x in gpos)
                elem.append(grandchild)
            elem.remove(child)
        _fuse_bodies(child)


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet; brax_torch.v2.mjcf loads free/hinge/slide joints, "
        "sphere/capsule/plane geoms and motors (see ROADMAP.md, queue A item 7)")


class _Compiler:
    def __init__(self, root: ElementTree.Element):
        self.root = root
        comp = root.find("compiler")
        self.degrees = (comp is None) or comp.get("angle", "degree") == "degree"
        self.inertiafromgeom = comp.get("inertiafromgeom", "auto") if comp is not None else "auto"
        opt = root.find("option")
        self.timestep = float(opt.get("timestep", 0.002)) if opt is not None else 0.002
        self.gravity = (_arr(opt.get("gravity", "0 0 -9.81"), 3) if opt is not None
                        else np.array([0.0, 0.0, -9.81]))
        self.iterations = int(opt.get("iterations", 50)) if opt is not None else 50
        self.predefined_pairs = opt is not None and opt.get("collision", "all") == "predefined"
        self.defaults: Dict[str, Dict[str, str]] = {}
        default = root.find("default")
        if default is not None:
            for child in default:
                self.defaults[child.tag] = dict(child.attrib)
        if root.find("asset") is not None and root.find("asset").findall("mesh"):
            raise _not_ported("mesh assets")
        self.body_names: List[str] = []
        self.body_parent: List[int] = []
        self.body_pos: List[np.ndarray] = []
        self.body_quat: List[np.ndarray] = []
        self.body_inertial: List[Optional[tuple]] = []
        self.body_geoms: List[list] = []
        self.joints: List[dict] = []
        self.geoms: List[dict] = []

    def _attrs(self, elem) -> Dict[str, str]:
        merged = dict(self.defaults.get(elem.tag, {}))
        merged.update(elem.attrib)
        return merged

    def _walk_body(self, elem, parent: int):
        a = self._attrs(elem)
        body_id = len(self.body_names)
        self.body_names.append(elem.get("name", f"body{body_id}"))
        self.body_parent.append(parent)
        self.body_pos.append(_arr(a.get("pos", "0 0 0"), 3))
        self.body_quat.append(_frame_quat(elem, self.degrees))
        self.body_inertial.append(None)
        self.body_geoms.append([])
        for child in elem:
            if child.tag == "joint":
                self._compile_joint(child, body_id)
            elif child.tag == "geom":
                self.body_geoms[body_id].append(self._compile_geom(child, body_id))
            elif child.tag == "inertial":
                ia = child.attrib
                self.body_inertial[body_id] = (
                    _arr(ia.get("pos", "0 0 0"), 3), _frame_quat(child, self.degrees),
                    _arr(ia["diaginertia"], 3) if "diaginertia" in ia else None,
                    float(ia["mass"]))
            elif child.tag == "body":
                self._walk_body(child, body_id)

    def _compile_joint(self, elem, body_id: int):
        a = self._attrs(elem)
        typ = a.get("type", "hinge")
        if typ not in ("free", "hinge", "slide"):
            raise _not_ported(f"{typ} joints")
        axis = _arr(a.get("axis", "0 0 1"), 3)
        rng = _arr(a.get("range", "0 0"), 2)
        if self.degrees and typ == "hinge":
            rng = rng * np.pi / 180.0
        self.joints.append(dict(
            body=body_id, type=typ, axis=axis / np.linalg.norm(axis),
            pos=_arr(a.get("pos", "0 0 0"), 3), limited=a.get("limited", "false") in ("true", "1"),
            range=rng, stiffness=float(a.get("stiffness", 0.0)),
            damping=float(a.get("damping", 0.0)), armature=float(a.get("armature", 0.0)),
            name=elem.get("name", f"joint{len(self.joints)}")))

    def _compile_geom(self, elem, body_id: int) -> dict:
        a = self._attrs(elem)
        typ = a.get("type", "sphere")
        if typ not in ("plane", "sphere", "capsule"):
            raise _not_ported(f"{typ} geoms")
        pos = _arr(a.get("pos", "0 0 0"), 3)
        quat = _frame_quat(elem, self.degrees)
        length = None
        if "fromto" in a:
            ft = _arr(a["fromto"], 6)
            p0, p1 = ft[:3], ft[3:]
            pos = (p0 + p1) / 2
            length = float(np.linalg.norm(p1 - p0))
            quat = _z_to_vec_quat(p1 - p0)
        rec = dict(
            type=typ, body=body_id, pos=pos, quat=quat,
            size=_arr(a["size"]) if "size" in a else np.zeros(3),
            density=float(a.get("density", 1000.0)),
            mass=float(a["mass"]) if "mass" in a else None,
            friction=_arr(a.get("friction", "1 0.005 0.0001"))[0], length=length,
            name=elem.get("name", f"geom{len(self.geoms)}"))
        self.geoms.append(rec)
        return rec

    def _geom_mass_inertia(self, g: dict):
        if g["type"] == "plane":
            return 0.0, np.zeros((3, 3)), np.zeros(3)
        if g["type"] == "sphere":
            return _sphere_mass_inertia(g["size"][0], g["density"], g["mass"])
        half = g["length"] / 2 if g["length"] is not None else g["size"][1]
        return _capsule_mass_inertia(g["size"][0], half, g["density"], g["mass"])

    def _body_inertia(self, body_id: int):
        """(mass, CoM position, principal-axes quaternion, principal moments)."""
        if not (self.inertiafromgeom == "true" or self.body_inertial[body_id] is None):
            ipos, iquat, idiag, mass = self.body_inertial[body_id]
            return mass, ipos, iquat, np.zeros(3) if idiag is None else idiag
        total_m, msum, parts = 0.0, np.zeros(3), []
        for g in self.body_geoms[body_id]:
            m, i_com, com_off = self._geom_mass_inertia(g)
            rot = _quat_to_mat(g["quat"])
            com_world = g["pos"] + rot @ com_off
            parts.append((m, com_world, rot @ i_com @ rot.T))
            total_m += m
            msum += m * com_world
        if total_m <= 0:
            return 0.0, np.zeros(3), np.array([1.0, 0, 0, 0]), np.zeros(3)
        ipos = msum / total_m
        itot = np.zeros((3, 3))
        for m, com, i_body in parts:
            d = com - ipos
            itot += i_body + m * ((d @ d) * np.eye(3) - np.outer(d, d))
        evals, evecs = np.linalg.eigh(itot)
        # descending principal moments, right-handed frame (MuJoCo convention)
        order = np.argsort(evals)[::-1]
        evals, evecs = evals[order], evecs[:, order]
        if np.linalg.det(evecs) < 0:
            evecs[:, 2] *= -1
        w = np.sqrt(max(1 + np.trace(evecs), 1e-12)) / 2
        iquat = np.array([w, (evecs[2, 1] - evecs[1, 2]) / (4 * w),
                          (evecs[0, 2] - evecs[2, 0]) / (4 * w),
                          (evecs[1, 0] - evecs[0, 1]) / (4 * w)])
        return total_m, ipos, iquat / np.linalg.norm(iquat), evals

    def compile(self, device) -> System:
        world = self.root.find("worldbody")
        if world is None:
            raise ValueError("mjcf missing <worldbody>")
        self.body_names.append("world")
        self.body_parent.append(-1)
        self.body_pos.append(np.zeros(3))
        self.body_quat.append(np.array([1.0, 0, 0, 0]))
        self.body_inertial.append(None)
        self.body_geoms.append([])
        for child in world:
            if child.tag == "geom":
                self.body_geoms[0].append(self._compile_geom(child, 0))
            elif child.tag == "body":
                self._walk_body(child, 0)
        nbody = len(self.body_names)

        joints_by_body: Dict[int, List[dict]] = {}
        for j in self.joints:
            joints_by_body.setdefault(j["body"], []).append(j)
        for b in range(1, nbody):
            if b not in joints_by_body:
                raise RuntimeError(f"body {self.body_names[b]} has no joint after fusing")

        link_types, link_order = "", list(range(1, nbody))
        joint_pos, ang, vel, lo, hi = [], [], [], [], []
        stiffness, damping, armature, jnt_meta = [], [], [], []
        any_limit, q_off, qd_off = False, 0, 0
        for b in link_order:
            js = joints_by_body[b]
            types = [j["type"] for j in js]
            if any(not np.allclose(j["pos"], js[0]["pos"]) for j in js):
                raise RuntimeError("joint stack: only one joint position allowed")
            joint_pos.append(js[0]["pos"])
            if types == ["free"]:
                link_types += "f"
                ang.append(np.eye(6, 3, -3))
                vel.append(np.eye(6, 3))
                lo.append(np.full(6, -np.inf))
                hi.append(np.full(6, np.inf))
                stiffness += [0.0] * 6
                damping += [js[0]["damping"]] * 6
                armature += [js[0]["armature"]] * 6
                jnt_meta.append((js[0]["name"], q_off, qd_off))
                q_off, qd_off = q_off + 7, qd_off + 6
            elif all(t in ("hinge", "slide") for t in types) and 1 <= len(types) <= 3:
                link_types += str(len(types))
                for j in js:
                    axis, zero = j["axis"].reshape(1, 3), np.zeros((1, 3))
                    ang.append(axis if j["type"] == "hinge" else zero)
                    vel.append(zero if j["type"] == "hinge" else axis)
                    lo.append(np.array([j["range"][0] if j["limited"] else -np.inf]))
                    hi.append(np.array([j["range"][1] if j["limited"] else np.inf]))
                    any_limit |= j["limited"]
                    stiffness.append(j["stiffness"])
                    damping.append(j["damping"])
                    armature.append(j["armature"])
                    jnt_meta.append((j["name"], q_off, qd_off))
                    q_off, qd_off = q_off + 1, qd_off + 1
            else:
                raise _not_ported(f"joint stack {types}")

        custom = self._get_custom(nbody)
        inertias = [self._body_inertia(b) for b in link_order]
        body_pos = np.stack([self.body_pos[b] for b in link_order])
        body_quat = np.stack([self.body_quat[b] for b in link_order])
        # free links keep their q in the world frame: no link transform
        for i, t in enumerate(link_types):
            if t == "f":
                body_pos[i] = np.zeros(3)
                body_quat[i] = np.array([1.0, 0, 0, 0])
        nl = len(link_order)
        link = dict(
            __type__="Link",
            transform=dict(__type__="Transform", pos=body_pos, rot=body_quat),
            joint=dict(__type__="Transform", pos=np.stack(joint_pos),
                       rot=np.tile(np.array([1.0, 0, 0, 0]), (nl, 1))),
            inertia=dict(
                __type__="Inertia",
                transform=dict(__type__="Transform", pos=np.stack([i[1] for i in inertias]),
                               rot=np.stack([i[2] for i in inertias])),
                i=np.stack([np.diag(i[3]) for i in inertias]),
                mass=np.array([i[0] for i in inertias])),
            invweight=np.zeros(nl),
            **{k: custom[k][1:] for k in ("constraint_stiffness", "constraint_damping",
                                          "constraint_limit_stiffness",
                                          "constraint_ang_damping")},
        )
        dof = dict(
            __type__="DoF",
            motion=dict(__type__="Motion", ang=np.concatenate(ang), vel=np.concatenate(vel)),
            armature=np.array(armature), stiffness=np.array(stiffness),
            damping=np.array(damping),
            limit=(np.concatenate(lo), np.concatenate(hi)) if any_limit else None,
            invweight=np.zeros(qd_off),
        )

        geoms = []
        for gi, g in enumerate(self.geoms):
            kw = dict(
                link_idx=None if g["body"] in (None, 0) else np.int64(g["body"] - 1),
                transform=dict(__type__="Transform", pos=g["pos"], rot=g["quat"]),
                friction=np.float64(g["friction"]),
                elasticity=np.float64(custom["elasticity"][gi]))
            if g["type"] == "plane":
                geoms.append(dict(__type__="Plane", **kw))
            elif g["type"] == "sphere":
                geoms.append(dict(__type__="Sphere", radius=g["size"][0], **kw))
            else:
                length = g["length"] if g["length"] is not None else 2 * g["size"][1]
                geoms.append(dict(__type__="Capsule", radius=g["size"][0], length=length, **kw))

        act_gear, act_ctrl, act_link, act_qid, act_qdid = [], [], [], [], []
        jnt_by_name = {name: (qid, qdid) for name, qid, qdid in jnt_meta}
        jname_link = {j["name"]: li for li, b in enumerate(link_order) for j in joints_by_body[b]}
        act_elem = self.root.find("actuator")
        for a in (act_elem if act_elem is not None else []):
            if a.tag != "motor":
                raise _not_ported(f"<{a.tag}> actuators")
            attrs = dict(self.defaults.get(a.tag, {}))
            attrs.update(a.attrib)
            qid, qdid = jnt_by_name[attrs["joint"]]
            limited = attrs.get("ctrllimited", "false") in ("true", "1")
            act_gear.append(float(attrs.get("gear", 1.0)))
            act_ctrl.append(_arr(attrs.get("ctrlrange", "-1 1"), 2) if limited
                            else np.array([-np.inf, np.inf]))
            act_link.append(jname_link[attrs["joint"]])
            act_qid.append(qid)
            act_qdid.append(qdid)

        init_q = (np.asarray(custom["init_qpos"], dtype=np.float64) if "init_qpos" in custom
                  else self._default_qpos(link_types, link_order))
        tree = dict(
            __type__="System", dt=np.float64(self.timestep), gravity=self.gravity, link=link,
            dof=dof, geoms=geoms, contacts=self._contacts(geoms),
            actuator=dict(__type__="Actuator", ctrl_range=np.array(act_ctrl).reshape(-1, 2),
                          gear=np.array(act_gear)),
            init_q=init_q, vel_damping=custom["vel_damping"], ang_damping=custom["ang_damping"],
            baumgarte_erp=custom["baumgarte_erp"],
            link_names=tuple(self.body_names[b] for b in link_order), link_types=link_types,
            link_parents=tuple(self.body_parent[b] - 1 for b in link_order),
            actuator_types="m" * len(act_gear), actuator_link_id=tuple(act_link),
            actuator_qid=tuple(act_qid), actuator_qdid=tuple(act_qdid),
            solver_iterations=self.iterations,
        )
        return _compute_invweight(System.from_numpy(tree, device="cpu")).to(device)

    def _default_qpos(self, link_types: str, link_order) -> np.ndarray:
        out = []
        for i, t in enumerate(link_types):
            if t == "f":
                out.extend(self.body_pos[link_order[i]])
                out.extend(self.body_quat[link_order[i]])
            else:
                out.extend([0.0] * int(t))
        return np.array(out)

    def _get_custom(self, nbody: int) -> Dict[str, np.ndarray]:
        """<custom> numeric/tuple parameters, with the JAX package's defaults."""
        default = {
            "vel_damping": (0.0, None), "ang_damping": (0.0, None), "baumgarte_erp": (0.1, None),
            "elasticity": (0.0, "geom"), "constraint_stiffness": (2000.0, "body"),
            "constraint_damping": (150.0, "body"), "constraint_limit_stiffness": (1000.0, "body"),
            "constraint_ang_damping": (0.0, "body"),
        }
        custom_elem = self.root.find("custom")
        numerics, tuples = {}, {}
        if custom_elem is not None:
            for n in custom_elem.findall("numeric"):
                numerics[n.get("name")] = _arr(n.get("data"))
            for t in custom_elem.findall("tuple"):
                tuples[t.get("name")] = [(e.get("objtype"), e.get("objname"), float(e.get("prm")))
                                         for e in t.findall("element")]
        sizes = {"body": nbody, "geom": len(self.geoms)}
        custom = {}
        for name, (val, typ) in default.items():
            v = numerics.get(name, np.array(val))
            size = sizes.get(typ)
            custom[name] = np.repeat(v, size) if size else np.array(v).squeeze()
        for name, v in numerics.items():
            custom.setdefault(name, v)
        geom_names = [g["name"] for g in self.geoms]
        for name, elems in tuples.items():
            for objtype, objname, prm in elems:
                idx = (geom_names if objtype == "geom" else self.body_names).index(objname)
                arr = custom[name]
                if np.ndim(arr) == 0:
                    arr = np.repeat(arr, sizes[objtype])
                arr = np.array(arr)
                arr[idx] = prm
                custom[name] = arr
        return custom

    def _contacts(self, geoms: List[dict]):
        """Typed contact pairs, stacked per pair type."""
        kind = lambda g: ({"Sphere": Sphere, "Capsule": Capsule, "Plane": Plane}[g["__type__"]],
                          g["link_idx"] is None)
        name_to_geom = {g["name"]: i for i, g in enumerate(self.geoms)}
        contact_elem = self.root.find("contact")
        pair_list = [(name_to_geom[p.get("geom1")], name_to_geom[p.get("geom2")])
                     for p in (contact_elem.findall("pair") if contact_elem is not None else [])]
        contacts = []
        for key_a, key_b in _COLLIDABLES:
            if self.predefined_pairs:
                pairs = []
                for ia, ib in pair_list:
                    ga, gb = geoms[ia], geoms[ib]
                    if (kind(ga), kind(gb)) == (key_a, key_b):
                        pairs.append((ga, gb))
                    elif (kind(ga), kind(gb)) == (key_b, key_a):
                        pairs.append((gb, ga))
            elif key_a == key_b:
                pairs = list(itertools.combinations([g for g in geoms if kind(g) == key_a], 2))
            else:
                pairs = list(itertools.product([g for g in geoms if kind(g) == key_a],
                                               [g for g in geoms if kind(g) == key_b]))
            pairs = [(a, b) for a, b in pairs
                     if a["link_idx"] is None or b["link_idx"] is None
                     or a["link_idx"] != b["link_idx"]]
            if pairs:
                contacts.append(tuple(_stack([p[i] for p in pairs]) for i in (0, 1)))
        return contacts


def _stack(trees):
    """Stacks a list of same-type geometry dicts along a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: (v if k == "__type__" else _stack([t[k] for t in trees]))
                for k, v in first.items()}
    if first is None:
        return None
    return np.stack([np.asarray(t) for t in trees])


def _compute_invweight(sys: System) -> System:
    """Mean inverse inertia at init_q, from the port's own pipeline:
    dof invweight = diag(M^-1); link invweight = trace(J M^-1 J^T) / 3 of
    the translational jacobian J at the link's CoM."""
    from brax_torch.v2 import kinematics
    from brax_torch.v2.generalized import constraint, dynamics, mass
    from brax_torch.v2.generalized.base import State

    q = sys.init_q[None]
    qd = torch.zeros((1, sys.qd_size()))
    x, xd = kinematics.forward(sys, q, qd)
    state = dynamics.transform_com(sys, State.zero(sys, 1).replace(q=q, qd=qd, x=x, xd=xd))
    mx = mass.matrix(sys, state)[0]
    mx_inv = torch.cholesky_solve(torch.eye(sys.qd_size()), torch.linalg.cholesky(mx))
    xi = x.do(sys.link.inertia.transform)
    link_iw = []
    for i in range(sys.num_links()):
        jac = constraint.pt_jac(sys, state.com, state.cdof.ang, state.cdof.vel, xi.pos[:, i], i)[0]
        link_iw.append(torch.trace(jac.T @ mx_inv @ jac) / 3.0)
    return sys.replace(link=sys.link.replace(invweight=torch.stack(link_iw)),
                       dof=sys.dof.replace(invweight=torch.diagonal(mx_inv).clone()))


def loads(xml: str, device="cuda") -> System:
    """A System from an MJCF XML string, on `device`."""
    elem = ElementTree.fromstring(xml)
    _fuse_bodies(elem)
    return _Compiler(elem).compile(torch.device(device))
