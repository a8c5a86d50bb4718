"""Frame loop with frame pacing, FPS stats, screenshots, live hotkeys, a
terminal preview and a watchdog (mirror of fluidx12_tpu/engine/frame_loop.py).

Mirrors the reference shell loop (Win32Application::Run + StepTimer +
CalculateFrameStats, FluidX12.cpp:662-710): runs frames back to back,
keeps at most FRAMES_IN_FLIGHT frames outstanding on the card (the analog
of the triple-buffered fence pacing, FluidX12.cpp:591-638), reports
steps/sec once per second, and saves PNG screenshots on request
(SaveImage, FluidX12.cpp:640-660).

Pacing on the card: a `torch.cuda.Event` is recorded after each dispatch
(a frame, or `step_frames(k)`'s k frames), and once more than
FRAMES_IN_FLIGHT are outstanding the loop waits for the oldest.  That wait
is the loop's only per-frame host sync; a frame is otherwise fetched to
the host only where it is written, previewed or ends the run, and the
state only where the watchdog checks it.  On the CPU there is nothing to
pace.
"""

from __future__ import annotations

import collections
import time
from typing import Optional

import numpy as np
import torch

from fluidx12_tpu_torch.engine.fluidx import FluidXEngine
from fluidx12_tpu_torch.utils.image import to_srgb_u8
from fluidx12_tpu_torch.utils.png import write_png


class _KeyPoller:
    """Non-blocking single-key reader for live hotkeys (ref OnKeyUp,
    FluidX12.cpp:311-334).  Active only when stdin is an interactive TTY;
    puts the terminal in cbreak mode for the duration of the run and
    decodes the arrow/F11 escape sequences to symbolic names."""

    ESC_MAP = {"[D": "left", "[C": "right", "[23~": "f11", "OP": "f1",
               "[11~": "f1"}

    def __init__(self):
        import sys

        self.enabled = False
        self._fd = None
        self._saved = None
        try:
            import termios
            import tty
        except ImportError:  # no termios on this platform: no hotkeys
            return
        try:
            if sys.stdin.isatty():
                self._fd = sys.stdin.fileno()
                self._saved = termios.tcgetattr(self._fd)
                tty.setcbreak(self._fd)
                self.enabled = True
        except (OSError, ValueError, termios.error):
            self.enabled = False

    def poll(self) -> Optional[str]:
        """Return one decoded key ('space', 'left', 'x', ...) or None."""
        if not self.enabled:
            return None
        import os
        import select
        import sys

        if not select.select([sys.stdin], [], [], 0)[0]:
            return None
        ch = os.read(self._fd, 1).decode(errors="ignore")
        if ch == "\x1b":  # escape sequence: drain what's immediately there
            seq = ""
            while select.select([sys.stdin], [], [], 0)[0] and len(seq) < 8:
                seq += os.read(self._fd, 1).decode(errors="ignore")
            return self.ESC_MAP.get(seq)
        if ch == " ":
            return "space"
        return ch.lower() or None

    def close(self):
        if self.enabled and self._saved is not None:
            import termios

            termios.tcsetattr(self._fd, termios.TCSADRAIN, self._saved)
            self.enabled = False


class FrameLoop:
    FRAMES_IN_FLIGHT = 3  # ref FrameCount (Fluid.h:35)
    # Warn when the fast advect's per-substep backtrace displacement
    # reaches this fraction of its MAX_DISP clamp (sim/advect_fast.py).
    CFL_WARN_FRACTION = 0.75

    def __init__(self, engine: FluidXEngine, show_fps: bool = True,
                 watchdog_every: int = 0, metrics_path: Optional[str] = None,
                 preview_every: int = 0):
        """watchdog_every > 0 enables a divergence watchdog: every N frames
        the state is checked for NaN/Inf and reset if corrupted, and the
        fast advect's CFL guard runs.  metrics_path appends JSON-lines
        frame metrics.

        preview_every > 0 draws every Nth frame to the terminal as ANSI
        half-block art (utils/termview.py), the live-display analog of the
        reference's window present (Win32Application.cpp:205-211).  Each
        drawn frame costs one device->host fetch."""
        self.engine = engine
        self.show_fps = show_fps
        self.watchdog_every = watchdog_every
        self.metrics_path = metrics_path
        self.preview_every = preview_every
        self.recoveries = 0
        self.cfl_warnings = 0
        self._in_flight = collections.deque()
        self._fps_window_start = time.perf_counter()
        self._fps_frame_count = 0
        self.last_fps: Optional[float] = None
        self._preview_active = False

    def run(self, num_frames: int, screenshot_path: Optional[str] = None,
            screenshot_every: Optional[int] = None,
            interactive: bool = False, batch: int = 1) -> Optional[np.ndarray]:
        """Run `num_frames`; returns the last frame as uint8 (H, W, 3).

        With interactive=True and a TTY on stdin, live hotkeys mirror the
        reference (OnKeyUp, FluidX12.cpp:311-334): Space pause, f/F1 FPS
        readout, left/right render method, s/F11 screenshot, x
        fast/faithful stack, a/d/w/z orbit and +/- dolly, p preview, q
        quit early.

        batch > 1 dispatches that many frames per call
        (FluidXEngine.step_frames) for headless throughput; interactive
        runs ignore it so hotkeys keep per-frame granularity."""
        keys = _KeyPoller() if interactive else None
        try:
            if self.preview_every > 0:
                self._preview_enter()
            if batch > 1 and keys is None:
                return self._run_batched(num_frames, screenshot_path,
                                         screenshot_every, batch)
            return self._run(num_frames, screenshot_path, screenshot_every, keys)
        finally:
            self._preview_leave()
            if keys is not None:
                keys.close()

    def _pace(self, image: torch.Tensor) -> None:
        """Record that a dispatch went out; wait for the oldest once more
        than FRAMES_IN_FLIGHT are outstanding (MoveToNextFrame waits on
        frame N-3)."""
        if image.device.type != "cuda":
            return
        event = torch.cuda.Event()
        event.record()
        self._in_flight.append(event)
        if len(self._in_flight) > self.FRAMES_IN_FLIGHT:
            self._in_flight.popleft().synchronize()

    def _finish(self, last, screenshot_path, screenshot_every):
        self._in_flight.clear()
        if last is None:
            return None
        arr = to_srgb_u8(last)
        if screenshot_path and not screenshot_every:
            write_png(screenshot_path.format(frame=self.engine.frame_index), arr)
        return arr

    def _run_batched(self, num_frames, screenshot_path, screenshot_every,
                     batch):
        last = None
        done = 0
        while done < num_frames:
            k = min(batch, num_frames - done)
            images = self.engine.step_frames(k)
            self._pace(images)
            for j in range(k):
                self._tick_fps()
                frame = done + j + 1
                if screenshot_every and frame % screenshot_every == 0 and screenshot_path:
                    path = screenshot_path.format(frame=frame)
                    write_png(path, to_srgb_u8(images[j]))
            prev = done
            done += k
            if self.watchdog_every and (done // self.watchdog_every
                                        > prev // self.watchdog_every):
                self._watchdog()
            if self._preview_active and (done // self.preview_every
                                         > prev // self.preview_every):
                self._preview_draw(images[-1])
            last = images[-1]
        return self._finish(last, screenshot_path, screenshot_every)

    def _run(self, num_frames, screenshot_path, screenshot_every, keys):
        last = None
        for i in range(num_frames):
            image = self.engine.step_frame()
            self._pace(image)
            self._tick_fps()
            if self.watchdog_every and (i + 1) % self.watchdog_every == 0:
                self._watchdog()
            if screenshot_every and (i + 1) % screenshot_every == 0 and screenshot_path:
                path = screenshot_path.format(frame=i + 1)
                write_png(path, to_srgb_u8(image))
            if self._preview_active and (i + 1) % self.preview_every == 0:
                self._preview_draw(image)
            last = image  # before the q-check, so quitting returns/saves
            # the frame that was just rendered, not its predecessor
            if keys is not None and self._handle_key(keys.poll(), image,
                                                     screenshot_path):
                break
        return self._finish(last, screenshot_path, screenshot_every)

    def _handle_key(self, key: Optional[str], image,
                    screenshot_path: Optional[str]) -> bool:
        """Apply one live hotkey; returns True to stop the loop (q)."""
        if key is None:
            return False
        eng = self.engine
        if key == "space":
            eng.toggle_pause()
            print(f"[fluidx12-tpu-torch] {'paused' if eng.is_paused else 'resumed'}")
        elif key in ("f", "f1"):
            self.show_fps = not self.show_fps
        elif key == "left":
            eng.prev_method()
            print(f"[fluidx12-tpu-torch] method: {eng.render_method.name}")
        elif key == "right":
            eng.next_method()
            print(f"[fluidx12-tpu-torch] method: {eng.render_method.name}")
        elif key in ("s", "f11"):
            path = (screenshot_path or "screenshot_{frame}.png").format(
                frame=eng.frame_index)
            write_png(path, to_srgb_u8(image))
            print(f"[fluidx12-tpu-torch] screenshot -> {path}")
        elif key == "x":
            fast = eng.toggle_ez()
            print(f"[fluidx12-tpu-torch] stack: {'fast' if fast else 'faithful'} "
                  f"(captured frames dropped)")
        elif key == "p":
            if self._preview_active:
                self._preview_leave()
            else:
                if self.preview_every <= 0:
                    self.preview_every = 1
                self._preview_enter()
        elif key in ("a", "d", "w", "z", "+", "-"):
            # Camera interaction: the reference tracks the mouse
            # (OnLButtonDown/OnMouseMove -> orbit, OnMouseWheel -> dolly,
            # FluidX12.cpp:337-396); on a terminal the same controls ride
            # keys: a/d orbit horizontally, w/z vertically, +/- dolly.  The
            # engine sees the new pose through its pose keys.
            cam = eng.camera
            step_px = cam.width * 0.04
            if key == "a":
                cam.orbit(-step_px, 0.0)
            elif key == "d":
                cam.orbit(step_px, 0.0)
            elif key == "w":
                cam.orbit(0.0, -step_px)
            elif key == "z":
                cam.orbit(0.0, step_px)
            elif key == "+":
                cam.dolly(1.0)
            else:
                cam.dolly(-1.0)
        elif key == "q":
            return True
        return False

    def _preview_enter(self):
        import sys

        from fluidx12_tpu_torch.utils import termview

        if not self._preview_active:
            sys.stdout.write(termview.ENTER_ALT_SCREEN)
            sys.stdout.flush()
            self._preview_active = True

    def _preview_leave(self):
        import sys

        from fluidx12_tpu_torch.utils import termview

        if self._preview_active:
            sys.stdout.write(termview.LEAVE_ALT_SCREEN)
            sys.stdout.flush()
            self._preview_active = False

    def _preview_draw(self, image):
        """Present one frame as half-block art + a one-line HUD."""
        import os
        import sys

        from fluidx12_tpu_torch.utils import termview

        try:
            cols, rows = os.get_terminal_size()
        except OSError:
            cols, rows = 80, 41
        art = termview.render_halfblocks(
            to_srgb_u8(image), max_cols=max(cols, 16), max_rows=max(rows - 1, 8))
        fps = f"{self.last_fps:6.1f} fps" if self.last_fps else "   ...    "
        hud = (f"[fluidx12-tpu-torch] {fps}  {self.engine.render_method.name}  "
               f"frame {self.engine.frame_index}  (p preview off, q quit)")
        sys.stdout.write(termview.CURSOR_HOME + art + "\n\x1b[K" + hud)
        sys.stdout.flush()

    def _watchdog(self):
        """Detect and recover from numerical divergence of the sim state,
        and warn when the fast advect nears its clamp.  Reads the state
        between frames (one host fetch of every 8th voxel, and the CFL
        guard's scalar); a reset is assigned through `engine.state`, into
        the buffers the captured frames read."""
        import json

        from fluidx12_tpu_torch.core.state import make_initial_state

        eng = self.engine
        c = eng.state.color[:, ::8, ::8, ::8].float().cpu().numpy()
        v = eng.state.velocity[:, ::8, ::8, ::8].float().cpu().numpy()
        healthy = bool(np.isfinite(c).all() and np.isfinite(v).all())
        if not healthy:
            self.recoveries += 1
            print(f"[fluidx12-tpu-torch] WATCHDOG: non-finite state at frame "
                  f"{eng.frame_index}; resetting simulation "
                  f"(recovery #{self.recoveries})")
            eng.state = make_initial_state(eng.config, eng.device)
        # CFL guard: the fast advect clamps backtrace displacement to
        # MAX_DISP voxels (the reference's forcing keeps CFL far below it,
        # CSAdvect.hlsl:50-54); a config that approaches the clamp would
        # silently diverge from the faithful twin, so warn loudly instead.
        cfg = eng.config
        cfl_disp = None
        if healthy and cfg.fast_sim and not eng.is_paused:
            from fluidx12_tpu_torch.sim.advect_fast import MAX_DISP, max_backtrace_disp

            cfl_disp = float(max_backtrace_disp(eng.state.velocity, cfg.time_step, cfg))
            if cfl_disp >= self.CFL_WARN_FRACTION * MAX_DISP:
                self.cfl_warnings += 1
                print(f"[fluidx12-tpu-torch] WATCHDOG: backtrace displacement "
                      f"{cfl_disp:.1f} voxels nears the fast-advect clamp "
                      f"(MAX_DISP={MAX_DISP}); the fast stack may diverge "
                      f"from the faithful twin -- reduce time_step/forces "
                      f"or switch to the faithful stack (x hotkey).")
        if self.metrics_path:
            rec = {
                "frame": eng.frame_index,
                "fps": self.last_fps,
                "healthy": healthy,
                "density_max": float(c[3].max()) if healthy else None,
                "speed_max": float(np.abs(v).max()) if healthy else None,
                "recoveries": self.recoveries,
                "cfl_disp": cfl_disp,
                "cfl_warnings": self.cfl_warnings,
            }
            with open(self.metrics_path, "a") as f:
                f.write(json.dumps(rec) + "\n")

    def _tick_fps(self):
        self._fps_frame_count += 1
        now = time.perf_counter()
        elapsed = now - self._fps_window_start
        if elapsed >= 1.0:
            self.last_fps = self._fps_frame_count / elapsed
            # With the preview active the HUD line carries the FPS; plain
            # prints would scroll the alt-screen drawing away.
            if self.show_fps and not self._preview_active:
                method = self.engine.render_method.name
                print(f"[fluidx12-tpu-torch] {self.last_fps:7.1f} fps    {method}")
            self._fps_window_start = now
            self._fps_frame_count = 0
