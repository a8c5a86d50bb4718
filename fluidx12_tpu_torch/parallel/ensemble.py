"""Ensembles of independent smoke simulations (mirror of
fluidx12_tpu/parallel/ensemble.py).

The domain modes (domain.py, render.py) spread one simulation over the
ranks; an ensemble runs many: parameter sweeps, a camera per client,
variance studies, batch offline renders.  Members share the config and
differ by their initial state (`init` draws distinct small velocity and
dye noise per member) or their SceneParams (every leaf carries a leading
member axis).  The JAX package vmaps `SmokeModel.step` over the members;
the port runs each member through `SmokeModel.step` in turn, so on the
card every member runs the config's hand kernels.  Members need no
collective: with a mesh (one process per device), each rank steps its
share of the members.

The composed mode (`make_ensemble_mesh`) lays members across the rows of
a members x slabs grid of ranks and Z-decomposes each member's grid over
its row: `sharded_ensemble_simulate` and `sharded_ensemble_render` run the
1D sharded step and render (domain.py, render.py) per local member on the
row's process group.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from fluidx12_tpu_torch.core.config import FluidConfig, RenderMethod
from fluidx12_tpu_torch.core.state import FluidState, SceneParams
from fluidx12_tpu_torch.models.smoke import SmokeModel
from fluidx12_tpu_torch.parallel.domain import sharded_step_fields, slab_of
from fluidx12_tpu_torch.parallel.light import sharded_light_supported
from fluidx12_tpu_torch.parallel.mesh import GridMesh
from fluidx12_tpu_torch.parallel.render import _render_local, slice_parallel_render_supported

MEMBER_AXIS = "m"


def _stack_params(params, batch: int) -> SceneParams:
    return SceneParams(*(p.expand((batch,) + tuple(p.shape)) for p in params))


def _member(tree, b: int):
    return type(tree)(*(t[b] for t in tree))


class SmokeEnsemble:
    """B independent sim + render pipelines on one device, or over the
    ranks of `mesh` (its size divides B; each rank holds B / size members).

        ens = SmokeEnsemble(FluidConfig(), batch=4, device="cuda")
        states, params = ens.init(seed=0), ens.default_params()
        states, images = ens.step(states, params)     # images (B, H, W, 3)
    """

    def __init__(self, config: FluidConfig, batch: int, mesh: Optional[GridMesh] = None,
                 method: RenderMethod = RenderMethod.RAY_MARCH_SEPARATE,
                 sh_coeffs: Optional[torch.Tensor] = None, device="cuda"):
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        if mesh is not None and batch % mesh.size:
            raise ValueError(f"batch {batch} must divide evenly over the {mesh.size}-device "
                             "mesh (pure data parallelism)")
        self.mesh = mesh
        self.model = SmokeModel(config, method, sh_coeffs,
                                device=mesh.device if mesh is not None else device)
        self.batch = batch

    def init(self, seed: int = 0, noise: float = 0.05) -> FluidState:
        """(B, ...) initial states with per-member velocity and dye noise,
        drawn on the host from a `torch.Generator` seeded with `seed` (the
        JAX package draws other bits from its PRNG), so that identical
        plumes diverge."""
        cfg = self.model.config
        z, y, x = cfg.zyx
        fields = torch.zeros((self.batch, 7, z, y, x), dtype=cfg.sim_dtype)
        if noise:
            gen = torch.Generator().manual_seed(seed)
            vel = noise * torch.randn((self.batch, 3, z, y, x), generator=gen)
            dye = 0.5 * noise * torch.rand((self.batch, 4, z, y, x), generator=gen)
            fields = torch.cat([vel, dye], dim=1).to(cfg.sim_dtype)
        return FluidState(fields=fields.to(self.model.device),
                          pressure=torch.zeros((self.batch, z, y, x), dtype=torch.float32,
                                               device=self.model.device))

    def default_params(self) -> SceneParams:
        """The model's default params with a leading member axis of B;
        replace any leaf by per-member values of the same leading size."""
        return _stack_params(self.model.default_params(), self.batch)

    def shard(self, tree):
        """This rank's members of a (B, ...) tuple of tensors, on its
        device; the whole tree, on the model's device, without a mesh."""
        if self.mesh is None:
            return type(tree)(*(t.to(self.model.device) for t in tree))
        per = self.batch // self.mesh.size
        lo = self.mesh.index * per
        return type(tree)(*(t[lo:lo + per].to(self.mesh.device) for t in tree))

    def step(self, states: FluidState, params: SceneParams) -> Tuple[FluidState, torch.Tensor]:
        """One frame for every member held here; returns (states,
        (B_local, H, W, 3))."""
        outs, images = [], []
        for b in range(states.fields.shape[0]):
            st, img = self.model.step(_member(states, b), _member(params, b))
            outs.append(st)
            images.append(img)
        return (FluidState(fields=torch.stack([s.fields for s in outs]),
                           pressure=torch.stack([s.pressure for s in outs])),
                torch.stack(images))


@dataclasses.dataclass
class EnsembleMesh:
    """A members x slabs grid of ranks: this rank's member row and its
    member group (the ranks of its slab column), and `z`, the row's
    Z-axis mesh."""

    n_members: int
    n_slabs: int
    member_index: int
    member_group: object
    z: GridMesh


def make_ensemble_mesh(n_members: int, n_slabs: int, device) -> EnsembleMesh:
    """The 2D (MEMBER_AXIS, Z_AXIS) mesh over the default process group's
    first n_members * n_slabs ranks (rank = member * n_slabs + slab).  Every
    rank of the default group calls it: each creates every row's and every
    column's group, in the same order, as `dist.new_group` requires."""
    need = n_members * n_slabs
    world = dist.get_world_size()
    if world < need:
        raise ValueError(f"need {need} devices, have {world}")
    me = dist.get_rank()
    rows = [tuple(range(m * n_slabs, (m + 1) * n_slabs)) for m in range(n_members)]
    cols = [tuple(range(s, need, n_slabs)) for s in range(n_slabs)]
    row_groups = [dist.new_group(list(r)) for r in rows]
    col_groups = [dist.new_group(list(c)) for c in cols]
    m, s = divmod(me, n_slabs)
    if me >= need:
        m, s = -1, -1
    z = GridMesh(group=row_groups[m] if m >= 0 else None, ranks=rows[m] if m >= 0 else (),
                 index=s, device=torch.device(device))
    return EnsembleMesh(n_members, n_slabs, m, col_groups[s] if s >= 0 else None, z)


def member_slabs(full, mesh: EnsembleMesh, z_axis: int) -> torch.Tensor:
    """This rank's (B / n_members, ...) members of a (B, ...) array, each
    cut to this rank's Z-slab along `z_axis` (counted in a member's dims)."""
    per = full.shape[0] // mesh.n_members
    return slab_of(full[mesh.member_index * per:(mesh.member_index + 1) * per], mesh.z,
                   z_axis + 1)


def sharded_ensemble_simulate(states: FluidState, time_step: float, config: FluidConfig,
                              mesh: EnsembleMesh) -> FluidState:
    """One step of this rank's members' slabs (B_local, 7, zl, Y, X) on the
    composed mesh (parallel/ensemble.py:135-176): the 1D sharded step of
    each member on its row."""
    dt = torch.tensor(float(time_step), dtype=torch.float32, device=states.fields.device)
    outs = [sharded_step_fields(f, q, time_step, dt, config, mesh.z)
            for f, q in zip(states.fields, states.pressure)]
    return FluidState(fields=torch.stack([f for f, _ in outs]),
                      pressure=torch.stack([q for _, q in outs]))


def sharded_ensemble_render(grids: torch.Tensor, params: SceneParams, config: FluidConfig,
                            mesh: EnsembleMesh, sh_coeffs=None) -> torch.Tensor:
    """(B_local, H, W, 4) premultiplied frames of this rank's members'
    (B_local, 4, zl, Y, X) colour slabs on the composed mesh
    (parallel/ensemble.py:179-225); each member may carry its own params
    (a leading member axis of B_local)."""
    if not slice_parallel_render_supported(config, mesh.n_slabs):
        raise ValueError(
            f"grid {config.grid_size} does not slice-parallelize over {mesh.n_slabs} Z-slabs "
            "(the 1D path would fall back to a gathered render; on the composed mesh, use a "
            "supported shape)")
    light_sharded = sharded_light_supported(config, mesh.n_slabs)
    return torch.stack([_render_local(g, _member(params, b), config, sh_coeffs, mesh.z,
                                      light_sharded) for b, g in enumerate(grids)])
