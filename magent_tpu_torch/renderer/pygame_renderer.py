"""PyGame live client: draws a game server's frames with zoom/pan, banner
text and an end screen, forwarding keyboard/mouse input to the server
(port of ``magent_tpu/renderer/pygame_renderer.py``; capability parity
with reference python/magent/renderer/pygame_renderer.py).  ``pygame`` is
imported by :meth:`PyGameRenderer.start` only.

Controls: arrow keys / WASD pan, +/- or mouse wheel zoom, space pauses,
ESC quits; left click is forwarded to the server (e.g. the battle server
drops reinforcements where clicked).
"""

from __future__ import annotations

from .base_renderer import BaseRenderer


class PyGameRenderer(BaseRenderer):
    def __init__(self):
        super().__init__()

    def start(self, server, animation_total=2, animation_stop=0,
              resolution=(800, 600), fps=20, max_frames=0):
        import pygame

        pygame.init()
        pygame.display.init()
        screen = pygame.display.set_mode(resolution, pygame.RESIZABLE)
        pygame.display.set_caption("magent_tpu")
        font = pygame.font.SysFont(None, 24)
        banner_font = pygame.font.SysFont(None, 32)
        clock = pygame.time.Clock()

        (map_w, map_h), groups, static = server.get_info()
        walls = static.get("wall", [])

        cell = max(2.0, min(resolution[0] / map_w, resolution[1] / map_h))
        origin_x, origin_y = 0.0, 0.0
        group_colors = [tuple(int(c) for c in g[2:5]) for g in groups]
        group_sizes = [(int(g[0]), int(g[1])) for g in groups]

        frame_id = 0
        running = True
        paused = False
        last_data = None
        prev_pos = None  # previous frame's positions for interpolation
        # animation_total ticks lerp between consecutive env frames, then
        # animation_stop ticks hold the final pose before the next fetch
        # (matches reference pygame_renderer.py:237-264)
        anim_progress = 0
        while running:
            width, height = screen.get_size()
            x_range = (int(origin_x), int(origin_x + width / cell) + 1)
            y_range = (int(origin_y), int(origin_y + height / cell) + 1)

            status = server.get_status(frame_id)

            for event in pygame.event.get():
                if event.type == pygame.QUIT:
                    running = False
                elif event.type == pygame.KEYDOWN:
                    key = event.key
                    if key == pygame.K_ESCAPE:
                        running = False
                    elif key in (pygame.K_LEFT, pygame.K_a):
                        origin_x -= 10 / cell * 8
                    elif key in (pygame.K_RIGHT, pygame.K_d):
                        origin_x += 10 / cell * 8
                    elif key in (pygame.K_UP, pygame.K_w):
                        origin_y -= 10 / cell * 8
                    elif key in (pygame.K_DOWN, pygame.K_s):
                        origin_y += 10 / cell * 8
                    elif key in (pygame.K_PLUS, pygame.K_EQUALS):
                        cell = min(cell * 1.25, 64)
                    elif key == pygame.K_MINUS:
                        cell = max(cell / 1.25, 1)
                    elif key == pygame.K_SPACE:
                        paused = not paused
                    else:
                        mx, my = pygame.mouse.get_pos()
                        gx = int(origin_x + mx / cell)
                        gy = int(origin_y + my / cell)
                        if server.keydown(frame_id, key, gx, gy):
                            frame_id += 1
                elif event.type == pygame.MOUSEBUTTONDOWN:
                    mx, my = event.pos
                    gx = int(origin_x + mx / cell)
                    gy = int(origin_y + my / cell)
                    pressed = pygame.mouse.get_pressed()
                    if server.mousedown(frame_id, pressed, gx, gy):
                        frame_id += 1
                elif event.type == pygame.MOUSEWHEEL:
                    cell = min(max(cell * (1.1 ** event.y), 1), 64)

            screen.fill((255, 255, 255))

            if status is None:  # game over: draw the end screen
                rows = server.get_endscreen(frame_id)
                y = height // 2 - 20 * len(rows)
                for row in rows:
                    x = width // 2 - 80
                    for text, color in row:
                        surf = banner_font.render(text, True, color)
                        screen.blit(surf, (x, y))
                        x += surf.get_width()
                    y += 40
                pygame.display.flip()
                clock.tick(fps)
                if max_frames and frame_id >= max_frames:
                    running = False
                continue

            # only advance the env while running: the live servers STEP the
            # game inside get_data, so calling it while paused or during a
            # status=False hold would silently play on behind a frozen UI;
            # between fetches, anim_progress sub-frames interpolate
            if status is True and not paused and (
                last_data is None
                or anim_progress > animation_total + animation_stop
            ):
                data = server.get_data(frame_id, x_range, y_range)
                if data is None:
                    frame_id += 1
                    continue
                prev_pos = last_data[0] if last_data is not None else None
                last_data = data
                frame_id += 1
                # no previous frame -> draw the new pose directly
                anim_progress = 0 if prev_pos is not None else animation_total
            if last_data is None:  # nothing fetched yet (e.g. pre-game hold)
                pygame.display.flip()
                clock.tick(fps)
                continue
            pos, events = last_data
            rate = (min(1.0, anim_progress / animation_total)
                    if animation_total > 0 else 1.0)

            def lerp(aid, x, y):
                """Blend toward the previous frame's position of the same
                agent (dict-keyed data only; fresh agents snap)."""
                if rate >= 1.0 or not hasattr(prev_pos, "get"):
                    return x, y
                old = prev_pos.get(aid) if prev_pos is not None else None
                if old is None:
                    return x, y
                return (old[0] * (1 - rate) + x * rate,
                        old[1] * (1 - rate) + y * rate)

            # map border + walls
            import pygame.draw as draw

            def to_px(x, y):
                return (int((x - origin_x) * cell), int((y - origin_y) * cell))

            draw.rect(screen, (120, 120, 120),
                      (*to_px(0, 0), int(map_w * cell), int(map_h * cell)), 1)
            for wpos in walls:
                px, py = to_px(wpos[0], wpos[1])
                draw.rect(screen, (127, 127, 127),
                          (px, py, max(1, int(cell)), max(1, int(cell))))

            # agents (positions eased toward this frame's pose)
            for aid, (x, y, g) in (pos.items() if hasattr(pos, "items")
                                   else enumerate(pos)):
                color = group_colors[g % len(group_colors)]
                w, h = group_sizes[g % len(group_sizes)]
                px, py = to_px(*lerp(aid, x, y))
                draw.rect(screen, color,
                          (px, py, max(1, int(w * cell)), max(1, int(h * cell))))

            # attack events
            for ev in (events if events is not None else []):
                tx, ty = int(ev[-2]), int(ev[-1])
                px, py = to_px(tx, ty)
                c = max(1, int(cell))
                draw.line(screen, (63, 63, 63), (px, py), (px + c, py + c), 1)
                draw.line(screen, (63, 63, 63), (px + c, py), (px, py + c), 1)

            # banners
            y = 8
            for row in server.get_banners(frame_id, resolution):
                x = 8
                for text, color in row:
                    surf = font.render(str(text), True, color)
                    screen.blit(surf, (x, y))
                    x += surf.get_width()
                y += 24

            pygame.display.flip()

            if status is True and not paused:
                anim_progress += 1
            if max_frames and frame_id >= max_frames:
                running = False
            clock.tick(fps)

        pygame.quit()
