"""URDF asset loader: body definitions as data, not code
(cartpoleplusplus_tpu/physics/urdf.py, a copy: the port cannot import the
reference package, whose `__init__` loads JAX).

`params_from_urdf` reads the three bodies ({ground,cart,pole}.urdf; the
package's own copies in ../models_urdf/ by default) and returns the
frozen `CartPoleParams` that the torch physics and the CUDA kernels take,
so an edit of the XML reaches kernel B1 as its folded constants
(ops/_native.py). Only the fields this topology uses are read (masses,
box and cylinder geometry, ground friction); anything else is ignored.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

from .params import CartPoleParams

DEFAULT_ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "models_urdf")


def _first(root, path, attr=None, default=None, cast=float):
    el = root.find(path)
    if el is None:
        return default
    if attr is None:
        return el
    v = el.get(attr)
    return default if v is None else cast(v)


def load_body(path: str) -> dict:
    """Mass and primitive geometry of the body in one URDF file."""
    root = ET.parse(path).getroot()
    out = {"name": root.get("name")}
    out["mass"] = _first(root, ".//inertial/mass", "value", 0.0)
    box = root.find(".//collision/geometry/box")
    if box is not None:
        out["box_size"] = tuple(float(x) for x in box.get("size").split())
    cyl = root.find(".//collision/geometry/cylinder")
    if cyl is not None:
        out["cylinder_length"] = float(cyl.get("length"))
        out["cylinder_radius"] = float(cyl.get("radius"))
    contact = root.find(".//collision/contact_coefficients")
    if contact is not None and contact.get("mu") is not None:
        out["friction"] = float(contact.get("mu"))
    return out


def params_from_urdf(asset_dir: str = DEFAULT_ASSET_DIR,
                     **overrides) -> CartPoleParams:
    """CartPoleParams from {ground,cart,pole}.urdf in `asset_dir`.

    Mapping: cart mass and box half-height -> cart_mass, cart_rest_z and
    pivot_height; pole mass and cylinder length -> pole_mass, pole_length;
    ground mu -> ground_friction. Keyword overrides win over the files.
    """
    cart = load_body(os.path.join(asset_dir, "cart.urdf"))
    pole = load_body(os.path.join(asset_dir, "pole.urdf"))
    ground = load_body(os.path.join(asset_dir, "ground.urdf"))
    kw = dict(
        cart_mass=cart["mass"],
        cart_rest_z=cart["box_size"][2] / 2.0,
        pivot_height=cart["box_size"][2] / 2.0,
        pole_mass=pole["mass"],
        pole_length=pole["cylinder_length"],
        ground_friction=ground.get("friction", 0.0),
    )
    kw.update(overrides)
    return CartPoleParams(**kw)
