"""One live feed (configuration ``stream_pump``, traffic of kind ``live``).

The stream CLI's ``--pump`` route: the shape calibrated on the feed's
first frames (``OnlineFitter.calibrate``), a request pump on the trip's
CUDA graph (``OnlineFitter.make_pump``), one sacrificial frame and a
restart from the calibrated state; all of that is set-up. In the window
each frame is due at a fixed rate (open loop) and is submitted alone,
when it is due or, when the pump is behind, as soon as the frame before
it is done; its latency runs from when it was due to its pose on the
host. The window holds the frames due in its ``seconds``.

The feed is one fixed recording: the model's weights and the keypoints'
noise come from the traffic's ``data_seed``, not from ``--seed``. The
online fit is a causal recursion, and on other noise it settles on one of
two branches (~11 or ~14 LM trips a frame over the window), so a seed
that chose the noise would choose the work.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import counts, gen, judge
from benchmark import reference as ref
from benchmark.runners import common
from benchmark.runners.video import _program


def build(cfg, traffic, device):
    """-> (the program's online fitter, the model's arrays, the feed's
    keypoints (N, K, 4) numpy)."""
    from smpltpu_torch.solve import OnlineConfig, OnlineFitter

    model = gen.make_model(device, gen.sub_seed(traffic["data_seed"], 0), **cfg["model_sizes"])
    m, cam, _ = _program(cfg, model, device)
    on = cfg["online"]
    ocfg = OnlineConfig(beta_pose=on["beta_pose"], lambda_temporal=on["lambda_t"],
                        max_iters=on["max_iters"], freeze_scale=True)
    fitter = OnlineFitter(m, cam, ocfg, device=device, dtype=torch.float32)
    n = traffic["frames"]
    kp = gen.feed_keypoints(model, ref.camera(cfg["camera"]["width"], cfg["camera"]["height"]),
                            traffic, n, device)
    return fitter, model, kp.cpu().numpy()


def feed(pump, kp, first: int, count: int, rate: float, t_start: float):
    """Frames first .. first + count - 1, frame i due at t_start + (i -
    first) / rate. -> (poses (count, P), costs, trips, latency s, how late
    each submit started after its due time, s)."""
    xs, costs, trips, lat, late = [], [], [], [], []
    for k in range(count):
        due = t_start + k / rate
        now = time.perf_counter()
        if now < due:
            time.sleep(max(0.0, due - now - 2e-4))
            while time.perf_counter() < due:
                pass
        late.append(time.perf_counter() - due)
        x, c, it, _ = pump.submit(kp[first + k])
        lat.append(time.perf_counter() - due)
        xs.append(x)
        costs.append(c)
        trips.append(it)
    return np.stack(xs), np.asarray(costs), np.asarray(trips), np.asarray(lat), np.asarray(late)


def run(cfg, traffic, seed, seconds, trace, clock, device):
    traffic = dict(traffic, seed=seed)
    dev = torch.device(device)
    marks = [("start, imports", clock.since_start())]
    fitter, model, kp = build(cfg, traffic, dev)
    marks.append(("model, program, feed", clock.since_start()))
    n_cal = cfg["calibration"]["frames"]
    calib_params = fitter.calibrate(kp[:n_cal], max_iters=cfg["calibration"]["max_iters"],
                                    beta_shape=cfg["calibration"]["beta_shape"])
    marks.append(("calibration", clock.since_start()))
    pump = fitter.make_pump()
    pump.start(fitter.prev, fitter.shape, fitter.has_prev)
    pump.submit(kp[0])                       # the sacrificial frame
    pump.stop()
    pump.start(fitter.prev, fitter.shape, fitter.has_prev)
    x_start = fitter.prev.cpu().numpy()
    shape = fitter.shape.cpu().numpy()
    common.reset_peak(dev)
    rate = float(traffic["rate_fps"])
    count = int(np.ceil(seconds * rate))
    need = n_cal + count + (traffic["trace_frames"] if trace else 0)
    if need > kp.shape[0]:
        raise RuntimeError(f"the feed needs {need} frames, the traffic makes {kp.shape[0]}")
    setup_s = clock.since_start()
    marks.append(("pump, sacrificial frame", setup_s))
    common.log_setup(marks)
    t0 = time.perf_counter()
    xs, costs, trips, lat, late = feed(pump, kp, n_cal, count, rate, t0)
    window_s = time.perf_counter() - t0
    lat_ms = lat * 1e3
    common.log(f"benchmark: {count} frames at {rate} frames/s in {window_s:.3f}s, "
               f"latency p50 {np.median(lat_ms):.3f} p95 {np.percentile(lat_ms, 95):.3f} "
               f"max {lat_ms.max():.3f} ms, trips mean {trips.mean():.2f}, "
               f"submit late max {late.max() * 1e3:.3f} ms, service a trip p50 "
               f"{np.median((lat - late) * 1e3 / np.maximum(trips, 1)):.4f} ms")
    e2e = {"stream_p95_ms": float(np.percentile(lat_ms, 95)),
           "stream_p50_ms": float(np.percentile(lat_ms, 50)), "setup_s": setup_s}
    ctx = {"trips": trips, "window_s": window_s, "cfg": cfg, "frames": count}
    traced = None
    if trace:
        m = traffic["trace_frames"]
        traced = common.trace_unit(lambda: feed(pump, kp, n_cal + count, m, rate,
                                                time.perf_counter()))
        ctx.update(trace=traced["trace"], traced_trips=traced["result"][2])
    pump.stop()
    peak = common.peak_bytes(dev)
    del pump, fitter
    common.free(dev)
    out = judge.StreamOut(kp=torch.as_tensor(kp[n_cal:n_cal + count]),
                          x=torch.as_tensor(xs), cost=torch.as_tensor(costs),
                          iters=torch.as_tensor(trips),
                          x_start=torch.as_tensor(x_start), shape=torch.as_tensor(shape),
                          calib_kp=torch.as_tensor(kp[:n_cal]),
                          calib_params=torch.as_tensor(calib_params))
    checks = judge.stream_checks(cfg, model, out, dev)
    return common.Result(e2e=e2e, ctx=ctx, checks=checks, attempted=count,
                         failed=int((~np.isfinite(xs).all(1)).sum()),
                         peak_bytes=peak, traced=traced)


def trip_work(trips: float) -> counts.Work:
    """One frame's online LM trips: keypoint rows 34, prior rows 69, the
    tether's 76 (counted by the single-frame count as P rows)."""
    return counts.stage_single_frame(1, ref.P_DIM, 34 + 69, trips, tr_solver="chol")
