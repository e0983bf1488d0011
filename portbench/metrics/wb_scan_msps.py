"""wb_scan_msps: wideband territory samples of the blocks that run_live
completed inside the window, over the window's seconds: the closed-loop
capacity of the live loop, the highest wire rate it could keep up with."""


def read(rec):
    if rec.window_s <= 0 or not rec.blocks:
        return None
    return rec.territory_samples / rec.window_s / 1e6
