"""Process groups spawned on one machine, and what each rank of
tests/test_torch_parallel.py's gloo groups runs.

`Ranks` / `run_ranks` run a function in a group of spawned processes, each
the rank of one process group on a free localhost port: the CPU tests' gloo
groups, and chip_smoke.py's group of ranks sharing one card.  A module of
its own, importing no JAX: a spawned rank imports the module of the
function it runs, and this one costs it torch and the port alone.  Inputs
and results are numpy arrays.
"""

import multiprocessing
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world_size, backend, address, args, results):
    try:
        dist.init_process_group(backend, init_method=address, world_size=world_size, rank=rank)
        try:
            out = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # handed to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))


class Ranks:
    """`fn(rank, world_size, *args)` started in `world_size` spawned
    processes, each the rank of one process group (`backend`, on a free
    localhost port); `results()` waits for them.

    `fn` and `args` must pickle (a module-level function; numpy arrays
    rather than card tensors), and so must the results.  The caller may
    work while the ranks run, and must end with `results()` or `stop()`.
    """

    def __init__(self, fn, world_size: int, backend: str = "gloo", args: tuple = ()):
        ctx = multiprocessing.get_context("spawn")
        self.world_size = world_size
        self._queue = ctx.Queue()
        address = f"tcp://localhost:{free_port()}"
        self._procs = [
            ctx.Process(target=_rank_main, args=(fn, rank, world_size, backend, address, args, self._queue),
                        daemon=True)
            for rank in range(world_size)
        ]
        for p in self._procs:
            p.start()

    def results(self, timeout: float = 600.0) -> list:
        """The ranks' results in rank order.  Raises RuntimeError with the
        rank's traceback where a rank fails; stops every process either
        way."""
        n = self.world_size
        out, done = [None] * n, set()
        deadline = time.monotonic() + timeout
        try:
            while len(done) < n:
                try:
                    rank, ok, value = self._queue.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(self._procs) if r not in done and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0]} exited {self._procs[dead[0]].exitcode} without a result") from None
                    if time.monotonic() > deadline:
                        raise RuntimeError(f"no result within {timeout} s") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {n} failed:\n{value}")
                out[rank] = value
                done.add(rank)
            for p in self._procs:
                p.join(timeout=60)
        finally:
            self.stop()
        return out

    def stop(self):
        """Stop every rank still running."""
        for p in self._procs:
            if p.is_alive():
                p.terminate()
                p.join()


def run_ranks(fn, world_size: int, backend: str = "gloo", args: tuple = (), timeout: float = 600.0) -> list:
    """`Ranks(fn, world_size, backend, args).results(timeout)`."""
    return Ranks(fn, world_size, backend, args).results(timeout)


def raster_and_nerf(rank, world, raster, nerf):
    """The sharded rasterizer and silhouette loss on a (1, world) mesh; with
    `nerf`, one sharded NeRF step on a mesh of `nerf["shape"]`."""
    from pytorch3d_tpu_torch.parallel import (
        get_device_mesh,
        make_nerf_train_step,
        rasterize_fragments_shard_map,
        sharded_silhouette_loss_and_grad,
    )

    torch.set_num_threads(1)  # the ranks share the machine's cores
    out = {}
    mesh = get_device_mesh((1, world))
    out["mesh"] = (mesh.shape, mesh.coordinate("dp"), mesh.coordinate("rays"))
    try:
        get_device_mesh((3, 5))
    except ValueError:
        out["bad shape raises"] = True
    fv, valid = torch.tensor(raster["fv"]), torch.tensor(raster["valid"])
    size = raster["size"]
    frags = rasterize_fragments_shard_map(fv, valid, size, mesh, blur_radius=1e-4, faces_per_pixel=4)
    out["frags"] = [t.numpy() for t in frags]
    loss, grad = sharded_silhouette_loss_and_grad(fv, valid, size, mesh)
    out["silhouette"] = (float(loss), grad.numpy())
    if nerf is not None:
        from pytorch3d_tpu_torch.convert import fov_perspective_cameras_from_numpy
        from pytorch3d_tpu_torch.models import RadianceFieldRenderer

        model = RadianceFieldRenderer(**nerf["config"], device="cpu")
        if rank == 0:  # the other ranks' weights come from rank 0's broadcast
            model.load_state_dict({k: torch.tensor(v) for k, v in nerf["state"].items()})
        cams = fov_perspective_cameras_from_numpy(*nerf["cameras"], device="cpu")
        nerf_mesh = get_device_mesh(nerf["shape"])
        out["nerf mesh"] = (nerf_mesh.shape, nerf_mesh.coordinate("dp"), nerf_mesh.coordinate("rays"))
        step = make_nerf_train_step(model, torch.optim.Adam(model.parameters(), lr=nerf["lr"]), mesh=nerf_mesh)
        draws = {k: torch.tensor(v) for k, v in nerf["draws"].items()}
        metrics = step(cams, torch.tensor(nerf["image"]), draws=draws)
        out["nerf"] = ({k: float(v) for k, v in metrics.items()},
                       {k: v.detach().numpy() for k, v in model.state_dict().items()})
    return out



def generic_model_steps(rank, world, spec):
    """`make_sharded_generic_train_step` on a (1, world) mesh: `spec["steps"]`
    Adam steps of a GenericModel (`spec["config"]`, rank 0's weights from
    `spec["seed"]`, the other ranks' from other seeds until the broadcast)
    on spec's frames; returns (the losses, the final state dict)."""
    from pytorch3d_tpu_torch.convert import fov_perspective_cameras_from_numpy
    from pytorch3d_tpu_torch.implicitron.models import GenericModel
    from pytorch3d_tpu_torch.parallel import get_device_mesh, make_sharded_generic_train_step

    torch.set_num_threads(1)  # the ranks share the machine's cores
    model = GenericModel(**spec["config"], device="cpu", generator=torch.Generator().manual_seed(spec["seed"] + rank))
    step = make_sharded_generic_train_step(model, torch.optim.Adam(model.parameters(), lr=spec["lr"]),
                                           get_device_mesh((1, world)))
    batch = {"camera": fov_perspective_cameras_from_numpy(*spec["cameras"], device="cpu"),
             **{k: torch.tensor(spec[k]) for k in ("image_rgb", "fg_probability")}}
    losses = [float(step(batch, s)) for s in range(spec["steps"])]
    return losses, {k: v.numpy() for k, v in model.state_dict().items()}
