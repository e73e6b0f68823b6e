"""The plain reference of the two timed loops' first steps, from the same
weights, inputs and draws the program is handed: SPI's RotBbox stage 2
(spi/training/coaches/rot_bbox_cx_coach.py) for one image, and the
StyleGAN-NADA twin-generator step (ZSSGAN/train.py) for one batch. Each
returns what `correct` compares: each step's loss, each trained leaf's
gradient norm at the first step, and each leaf's change after the steps.

Adam is written out (Kingma and Ba), as torch.optim.Adam computes it."""

from __future__ import annotations

import torch

from benchmark.reference import camera, clip, eg3d, perception


class Adam:
    def __init__(self, params: dict, lr, betas=(0.9, 0.999), eps=1e-8):
        self.params, self.lr, self.betas, self.eps = params, lr, betas, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self):
        self.t += 1
        b1, b2 = self.betas
        for k, p in self.params.items():
            if p.grad is None:
                continue
            g = p.grad
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k].sqrt() / (1 - b2 ** self.t) ** 0.5).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lr / (1 - b1 ** self.t))
            p.grad = None


def _norms(tensors):
    return {k: float(v.detach().double().norm()) for k, v in tensors.items()}


def _is_buffer(name):
    return name.endswith("noise_const") or name.endswith("w_avg")


def rotbbox(P0, cfg, lp, box, x, s, draws, n_steps, lpips_cfg=perception.VGG16_CFG):
    """`n_steps` RotBbox steps for one image. P0: the generator's starting
    tensors; lp, box: LPIPS and BoxCX weights; x: {'target' (1, 3, R, R),
    'camera' (1, 25), 'ws' (1, L, w), 'noise' {buffer: (R, R)},
    'face_mask', 'landmarks'}; s: the coach's settings (dict); draws: per
    step, as the program's coach takes them."""
    params = {k: v.clone().requires_grad_(True) for k, v in P0.items() if not _is_buffer(k)}
    buffers = {k: v for k, v in P0.items() if _is_buffer(k)}
    opt = Adam(params, s["learning_rate"])
    res = cfg["neural_rendering_resolution"]
    with torch.no_grad():
        target_feats = perception.lpips_features(lp, x["target"], lpips_cfg)
        stable = eg3d.planes(P0, cfg, x["ws"], {k: v for k, v in buffers.items()})[0]
        mirror_on = bool(camera.mirror_weight(x["camera"])[0] > 0) and s["mirror_rot_lambda"] > 0
    k = s["rot_bs"]

    def tile(t):
        return t.expand(k, *t.shape[1:])

    out = {"loss": [], "grad": None, "change": None}
    for step in range(n_steps):
        d = draws[step]
        P = {**buffers, **params}
        pl = eg3d.planes(P, cfg, x["ws"], x["noise"])[0]
        leaf = pl.detach().requires_grad_(True)
        grads = [leaf, *params.values()]
        o = eg3d.render(P, cfg, leaf, x["ws"], x["camera"], d["recon"])
        lpv = perception.lpips(lp, o["image"], target_feats, lpips_cfg)
        loss = (o["image"] - x["target"]).square().mean() * s["l2_lambda"] \
            + lpv * s["lpips_lambda"]
        out["loss"].append(float(lpv.detach()))
        gen_depth = o["image_depth"].detach()
        loss.backward(inputs=grads)
        del o, loss
        if step % k == 0:
            dr = d["rot"]
            cams = camera.surrounding(x["camera"], *dr["cameras"], s["yaw_range"],
                                      s["pitch_range"])
            o = eg3d.render(P, cfg, leaf, x["ws"], cams, dr["render"])
            with torch.no_grad():
                wimg, wmask = perception.warp(cams, o["image_depth"], tile(x["target"]),
                                              tile(x["camera"]), tile(gen_depth),
                                              tile(x["face_mask"]), s["warp_eps"], res)
                wfeats = perception.lpips_features(lp, wimg, lpips_cfg)
            (perception.lpips(lp, o["image"] * wmask, wfeats, lpips_cfg)
             * s["rot_lambda"] * k).backward(inputs=grads)
            del o
            if mirror_on:
                dm = d["mirror"]
                cam_m = camera.mirror(x["camera"])
                cams = camera.surrounding(cam_m, *dm["cameras"], s["yaw_range"],
                                          s["pitch_range"])
                o = eg3d.render(P, cfg, leaf, x["ws"], cams, dm["render"])
                with torch.no_grad():
                    wimg, wmask = perception.warp(
                        cams, o["image_depth"], tile(x["target"].flip(3)), tile(cam_m),
                        tile(gen_depth.flip(3)), tile(x["face_mask"].flip(3)), s["warp_eps"],
                        res)
                (perception.box_cx(box, o["image"].flip(3) * wmask.flip(3), wimg.flip(3),
                                   tile(x["landmarks"])) * s["mirror_rot_lambda"] * k
                 ).backward(inputs=grads)
                del o
            dd = d["depth"]
            cams = camera.sample_camera(*dd["cameras"], s["depth_yaw_range"],
                                        s["depth_pitch_range"])
            depth = eg3d.render(P, cfg, leaf, x["ws"], cams, dd["render"], False)["image_depth"]
            with torch.no_grad():
                ref_depth = eg3d.render(P0, cfg, stable, x["ws"], cams, dd["render"],
                                        False)["image_depth"]
            ((ref_depth - depth).square().mean() * s["depth_lambda"]).backward(inputs=grads)
            del depth
        pl.backward(leaf.grad, inputs=list(params.values()))
        if step == 0:
            out["grad"] = _norms({n: p.grad for n, p in params.items() if p.grad is not None})
        opt.step()
    out["change"] = _norms({n: params[n].detach() - P0[n] for n in params})
    return out


def editing(P0, cfg, clips, mask, settings, draws, n_steps):
    """`n_steps` twin-generator steps. clips: [(weights, CLIP config,
    weight in the sum, text direction)]; mask: the trained leaves' names;
    settings: {'lr', 'g_reg_every', 'truncation'}; draws: per step {'w':
    {'z'}, 'frozen', 'trainable': {'noise', 'stratified', 'exponential'}}."""
    params = {k: P0[k].clone().requires_grad_(True) for k in mask if not _is_buffer(k)}
    r = settings["g_reg_every"] / (settings["g_reg_every"] + 1)
    opt = Adam(params, settings["lr"] * r, (0.0 ** r, 0.99 ** r), 1e-8)
    res = cfg["neural_rendering_resolution"]
    m = res * res
    out = {"loss": [], "grad": None, "change": None}
    for step in range(n_steps):
        d = draws[step]
        z = d["w"]["z"]
        n = z.shape[0]
        cam = camera.canonical(0.0, z.device).expand(n, 25)
        with torch.no_grad():
            ws = eg3d.mapping(P0, cfg, z, cam, psi=settings["truncation"])

        def images(P, dr):
            pl = eg3d.planes(P, cfg, ws, dr["noise"])
            return torch.cat([eg3d.render(
                P, cfg, pl[b], ws[b:b + 1], cam[b:b + 1],
                {"stratified": dr["stratified"][b:b + 1],
                 "exponential": dr["exponential"][b * m:(b + 1) * m]})["image"]
                for b in range(n)])

        with torch.no_grad():
            frozen = images(P0, d["frozen"])
        trained = images({**P0, **params}, d["trainable"])
        loss = sum(wt * clip.directional_loss(cp, ccfg, frozen, trained, direction)
                   for cp, ccfg, wt, direction in clips)
        out["loss"].append(float(loss.detach()))
        loss.backward(inputs=list(params.values()))
        if step == 0:
            out["grad"] = _norms({k: p.grad for k, p in params.items() if p.grad is not None})
        opt.step()
    out["change"] = _norms({k: params[k].detach() - P0[k] for k in params})
    return out
