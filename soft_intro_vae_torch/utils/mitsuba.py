"""Mitsuba2 point-cloud scene generation (the port's copy of the JAX package's
utils/mitsuba.py).

Capability parity with the reference's soft_intro_vae_3d/render/
render_mitsuba2_pc.py: standardize the cloud to a unit bounding box, map
positions to colors, emit one sphere per point into a Mitsuba 0.6 XML scene
(same camera/material/lighting parameters), and optionally invoke a user-
provided mitsuba binary per scene (the binary itself is not shipped here).
"""

from __future__ import annotations

import os
import subprocess
from typing import List, Optional

import numpy as np

_SCENE_HEAD = """<scene version="0.6.0">
    <integrator type="path">
        <integer name="maxDepth" value="-1"/>
    </integrator>
    <sensor type="perspective">
        <float name="farClip" value="100"/>
        <float name="nearClip" value="0.1"/>
        <transform name="toWorld">
            <lookat origin="6,6,3" target="0,0,0" up="0,0,1"/>
        </transform>
        <float name="fov" value="25"/>
        <sampler type="independent">
            <integer name="sampleCount" value="256"/>
        </sampler>
        <film type="hdrfilm">
            <integer name="width" value="1920"/>
            <integer name="height" value="1080"/>
            <rfilter type="gaussian"/>
        </film>
    </sensor>
    <bsdf type="roughplastic" id="surfaceMaterial">
        <string name="distribution" value="ggx"/>
        <float name="alpha" value="0.05"/>
        <float name="intIOR" value="1.46"/>
        <rgb name="diffuseReflectance" value="1,1,1"/>
    </bsdf>
"""

_SPHERE = """    <shape type="sphere">
        <float name="radius" value="{radius}"/>
        <transform name="toWorld">
            <translate x="{x}" y="{y}" z="{z}"/>
        </transform>
        <bsdf type="diffuse">
            <rgb name="reflectance" value="{r},{g},{b}"/>
        </bsdf>
    </shape>
"""

_SCENE_TAIL = """    <shape type="rectangle">
        <ref name="bsdf" id="surfaceMaterial"/>
        <transform name="toWorld">
            <scale x="20" y="20" z="1"/>
            <translate x="0" y="0" z="-0.5"/>
        </transform>
    </shape>
    <shape type="rectangle">
        <transform name="toWorld">
            <scale x="10" y="10" z="1"/>
            <lookat origin="-4,4,20" target="0,0,0" up="0,0,1"/>
        </transform>
        <emitter type="area">
            <rgb name="radiance" value="6,6,6"/>
        </emitter>
    </shape>
</scene>
"""


def standardize_bbox(pcl: np.ndarray, points_per_object: int,
                     rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Center + scale the cloud into [-0.5, 0.5]^3 on a random point subset
    (render_mitsuba2_pc.py:97-107)."""
    rng = rng or np.random.default_rng(0)
    n = pcl.shape[0]
    idx = rng.choice(n, min(points_per_object, n), replace=False)
    pcl = pcl[idx]
    mins, maxs = pcl.min(axis=0), pcl.max(axis=0)
    center = (mins + maxs) / 2.0
    scale = float((maxs - mins).max())
    return ((pcl - center) / scale).astype(np.float32)


def position_colormap(p: np.ndarray) -> np.ndarray:
    """Per-point RGB from normalized position (render_mitsuba2_pc.py:89-94)."""
    vec = np.clip(p, 0.001, 1.0)
    return vec / np.sqrt((vec ** 2).sum(axis=-1, keepdims=True))


def pointcloud_to_xml(pcl: np.ndarray, points_per_object: int = 2048,
                      radius: float = 0.015, seed: int = 0) -> str:
    """One (N, 3) cloud -> a complete Mitsuba XML scene string."""
    pcl = standardize_bbox(np.asarray(pcl, np.float32), points_per_object,
                           np.random.default_rng(seed))
    pcl = pcl.copy()
    pcl[:, 1] += 0.0125  # the reference's y-offset (:188)
    colors = position_colormap(pcl + np.array([0.5, 0.5, 0.5 - 0.0125], np.float32))
    parts = [_SCENE_HEAD]
    for p, c in zip(pcl, colors):
        parts.append(_SPHERE.format(radius=radius, x=p[0], y=p[1], z=p[2],
                                    r=c[0], g=c[1], b=c[2]))
    parts.append(_SCENE_TAIL)
    return "".join(parts)


def render_pointclouds(path: str, out_dir: Optional[str] = None,
                       points_per_object: int = 2048,
                       mitsuba_binary: Optional[str] = None) -> List[str]:
    """npy/npz/ply -> one XML scene per cloud; runs mitsuba when a binary
    path is supplied (render_mitsuba2_pc.py:149-210 flow)."""
    base, ext = os.path.splitext(path)
    out_dir = out_dir or os.path.dirname(os.path.abspath(path))
    name = os.path.basename(base)
    if ext == ".npy":
        clouds = np.load(path)
    elif ext == ".npz":
        clouds = np.load(path)["pred"]
    elif ext == ".ply":
        from soft_intro_vae_torch.data.shapenet import load_ply

        clouds = load_ply(path)
    else:
        raise ValueError(f"unsupported point-cloud format {ext!r}")
    if clouds.ndim == 2:
        clouds = clouds[None]
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for i, pcl in enumerate(clouds):
        xml_path = os.path.join(out_dir, f"{name}_{i:02d}.xml")
        with open(xml_path, "w") as f:
            f.write(pointcloud_to_xml(pcl, points_per_object, seed=i))
        written.append(xml_path)
        if mitsuba_binary:
            exr = os.path.join(out_dir, f"{name}_{i:02d}.exr")
            if not os.path.exists(exr):
                subprocess.run([mitsuba_binary, xml_path], check=False)
    return written
