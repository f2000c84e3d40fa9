"""Operations of HRNet-W48's convolutions on one input crop, counted from
the configuration's widths (2·in·k²·out per output pixel; BatchNorm, the
nearest upsampling and the additions left out)."""

from .humaniflow import conv_out


def conv_flops(hrnet_cfg: dict) -> int:
    c, blocks = hrnet_cfg["STAGE_CHANNELS"], hrnet_cfg["STAGE_BLOCKS"]
    w, h = hrnet_cfg["INPUT_WH"]
    total = 0

    def conv(cin, cout, k, hw):
        nonlocal total
        total += 2 * cin * k * k * cout * hw[0] * hw[1]

    hw = (conv_out(h, 3, 2), conv_out(w, 3, 2))
    conv(3, 64, 3, hw)
    hw = (conv_out(hw[0], 3, 2), conv_out(hw[1], 3, 2))
    conv(64, 64, 3, hw)
    for k in range(4):
        in_ch = 64 if k == 0 else 256
        conv(in_ch, 64, 1, hw)
        conv(64, 64, 3, hw)
        conv(64, 256, 1, hw)
        if in_ch != 256:
            conv(in_ch, 256, 1, hw)
    sizes = [hw]
    for _ in range(3):
        sizes.append((conv_out(sizes[-1][0], 3, 2), conv_out(sizes[-1][1], 3, 2)))
    conv(256, c[0], 3, sizes[0])
    conv(256, c[1], 3, sizes[1])
    for s, n_modules in zip((2, 3, 4), hrnet_cfg["STAGE_MODULES"]):
        if s > 2:
            conv(c[s - 2], c[s - 1], 3, sizes[s - 1])
        for m in range(n_modules):
            for b in range(s):
                total += blocks * 2 * (2 * c[b] * 9 * c[b] * sizes[b][0] * sizes[b][1])
            for i in range(1 if (s == 4 and m == n_modules - 1) else s):
                for j in range(s):
                    if j > i:
                        conv(c[j], c[i], 1, sizes[j])
                    for k in range(i - j if j < i else 0):
                        conv(c[j], c[i] if k == i - j - 1 else c[j], 3, sizes[j + k + 1])
    conv(c[0], hrnet_cfg["NUM_JOINTS"], 1, sizes[0])
    return total
