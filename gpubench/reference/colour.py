"""sRGB <-> CIELAB and the training shrink, in plain PyTorch.

The benchmark's own copy of the colour arithmetic that the k-means
quantizer specifies, operation for operation, so that the reference lands
on the same float32 bits as a correct implementation:

- `GAMMA_BITS`: entry `i` is the linear light (x100) of the u8 sRGB code
  `i`, `(((i / 255 + 0.055) / 1.055) ** 2.4 if i / 255 > 0.04045 else
  (i / 255) / 12.92) * 100` as the original system's float32 evaluates it.
  Stored as bit patterns: no float32 `pow` here reproduces them.
- `FOLDED_GAMMA_DIFF`: the entries that move when the divides are folded
  into multiplies by reciprocals and `x * (1 / 255) + 0.055` is one fused
  multiply-add, the form the training's seeding reads.
- Lab from linear light: a left-to-right matrix row, a true divide by the
  white point, `pow(t, 1/3)` with the 7.787 linear toe; `srgb8_to_lab_folded`
  is the same with each row as two fused multiply-adds, the white point and
  the toe's slope folded into multiplies and the cube root correctly
  rounded.
- Lab -> u8 sRGB: the exact inverse, rounded half to even.
- `shrink_u8`: the bilinear training shrink, sampled at the corner of each
  output texel with clamp-to-edge, each blend one fused multiply-add.

Every division by a constant is a true IEEE division (`div`); CUDA's
`tensor / number` multiplies by a reciprocal instead. Imports nothing of
the program.
"""

from __future__ import annotations

import numpy as np
import torch

GAMMA_BITS = (
    0x00000000, 0x3CF8A639, 0x3D78A639, 0x3DBA7CAB, 0x3DF8A639, 0x3E1B67E4,
    0x3E3A7CAB, 0x3E599171, 0x3E78A639, 0x3E8BDD81, 0x3E9B67E4, 0x3EAB57B6,
    0x3EBC3CB6, 0x3ECE10C5, 0x3EE0D782, 0x3EF4947B, 0x3F04A597, 0x3F0F7F7F,
    0x3F1AD9A1, 0x3F26B5A4, 0x3F33151F, 0x3F3FF9A8, 0x3F4D64CB, 0x3F5B5810,
    0x3F69D4F5, 0x3F78DCF9, 0x3F8438C4, 0x3F8C4A09, 0x3F94A301, 0x3F9D445C,
    0x3FA62ECB, 0x3FAF62FA, 0x3FB8E196, 0x3FC2AB43, 0x3FCCC0A6, 0x3FD72268,
    0x3FE1D126, 0x3FECCD84, 0x3FF8181F, 0x4001D8C8, 0x4007CD3A, 0x400DE9B1,
    0x40142E79, 0x401A9BDD, 0x40213226, 0x4027F19E, 0x402EDA8C, 0x4035ED39,
    0x403D29EA, 0x404490E7, 0x404C2274, 0x4053DED8, 0x405BC657, 0x4063D931,
    0x406C17AB, 0x40748208, 0x407D188E, 0x4082EDBB, 0x40876582, 0x408BF3BC,
    0x4090988A, 0x40955409, 0x409A265B, 0x409F0F9E, 0x40A40FF3, 0x40A92773,
    0x40AE563F, 0x40B39C76, 0x40B8FA36, 0x40BE6F9C, 0x40C3FCC8, 0x40C9A1D1,
    0x40CF5ED9, 0x40D533FB, 0x40DB2154, 0x40E12700, 0x40E7451C, 0x40ED7BC4,
    0x40F3CB12, 0x40FA3324, 0x41005A0B, 0x4103A700, 0x41070080, 0x410A6697,
    0x410DD956, 0x411158C6, 0x4114E4F5, 0x41187DF2, 0x411C23C9, 0x411FD686,
    0x41239638, 0x412762EA, 0x412B3CAB, 0x412F2385, 0x41331786, 0x413718BC,
    0x413B2730, 0x413F42F1, 0x41436C0D, 0x4147A28C, 0x414BE67B, 0x415037E8,
    0x415496DF, 0x4159036C, 0x415D7D98, 0x41620573, 0x41669B07, 0x416B3E60,
    0x416FEF89, 0x4174AE8E, 0x41797B7B, 0x417E565F, 0x41819F9F, 0x41841B14,
    0x41869D92, 0x41892723, 0x418BB7C9, 0x418E4F8C, 0x4190EE6F, 0x4193947A,
    0x419641B1, 0x4198F61A, 0x419BB1BA, 0x419E7498, 0x41A13EB8, 0x41A4101E,
    0x41A6E8D4, 0x41A9C8DA, 0x41ACB03D, 0x41AF9EF9, 0x41B29517, 0x41B5929D,
    0x41B89791, 0x41BBA3F9, 0x41BEB7D7, 0x41C1D330, 0x41C4F60C, 0x41C8206F,
    0x41CB525E, 0x41CE8BDC, 0x41D1CCF3, 0x41D515A4, 0x41D865F6, 0x41DBBDED,
    0x41DF1D8F, 0x41E284E0, 0x41E5F3E5, 0x41E96AA4, 0x41ECE921, 0x41F06F61,
    0x41F3FD6A, 0x41F7933E, 0x41FB30E5, 0x41FED664, 0x420141DE, 0x42031C7B,
    0x4204FB0B, 0x4206DD8F, 0x4208C40A, 0x420AAE80, 0x420C9CF3, 0x420E8F63,
    0x421085D3, 0x42128047, 0x42147EC0, 0x42168140, 0x421887CB, 0x421A9262,
    0x421CA108, 0x421EB3BE, 0x4220CA89, 0x4222E568, 0x4225045F, 0x42272771,
    0x42294E9E, 0x422B79EA, 0x422DA957, 0x422FDCE7, 0x4232149C, 0x42345078,
    0x4236907E, 0x4238D4B1, 0x423B1D11, 0x423D69A1, 0x423FBA64, 0x42420F5C,
    0x4244688A, 0x4246C5F2, 0x42492796, 0x424B8D76, 0x424DF795, 0x425065F5,
    0x4252D899, 0x42554F83, 0x4257CAB6, 0x425A4A32, 0x425CCDFA, 0x425F5611,
    0x4261E279, 0x42647331, 0x4267083F, 0x4269A1A3, 0x426C3F60, 0x426EE179,
    0x427187ED, 0x427432C1, 0x4276E1F6, 0x4279958C, 0x427C4D8A, 0x427F09EE,
    0x4280E55D, 0x428247F9, 0x4283ACCB, 0x428513D5, 0x42867D18, 0x4287E894,
    0x4289564B, 0x428AC63E, 0x428C386C, 0x428DACD9, 0x428F2384, 0x42909C6E,
    0x42921799, 0x42939505, 0x429514B4, 0x429696A6, 0x42981ADC, 0x4299A158,
    0x429B2A1B, 0x429CB524, 0x429E4276, 0x429FD211, 0x42A163F6, 0x42A2F827,
    0x42A48EA3, 0x42A6276C, 0x42A7C284, 0x42A95FEA, 0x42AAFFA0, 0x42ACA1A7,
    0x42AE4600, 0x42AFECAA, 0x42B195AB, 0x42B340FE, 0x42B4EEA9, 0x42B69EA7,
    0x42B85100, 0x42BA05AD, 0x42BBBCB8, 0x42BD7619, 0x42BF31D8, 0x42C0EFF0,
    0x42C2B069, 0x42C4733B, 0x42C6386F, 0x42C80000,
)

FOLDED_GAMMA_DIFF = {
    7: 0x3E599173, 9: 0x3E8BDD80, 16: 0x3F04A595, 19: 0x3F26B5A2,
    32: 0x3FB8E194, 38: 0x3FF8181C, 39: 0x4001D8C6, 45: 0x4027F19D,
    46: 0x402EDA8B, 48: 0x403D29EE, 49: 0x404490EB, 50: 0x404C2279,
    51: 0x4053DEDC, 52: 0x405BC659, 53: 0x4063D933, 54: 0x406C17AE,
    55: 0x4074820D, 58: 0x40876584, 59: 0x408BF3BF, 60: 0x4090988C,
    61: 0x4095540C, 62: 0x409A265E, 63: 0x409F0FA0, 70: 0x40C3FCC5,
    71: 0x40C9A1CF, 84: 0x410DD954, 85: 0x411158C4, 96: 0x413B2732,
    97: 0x413F42F3, 101: 0x415037EB, 102: 0x415496E2, 103: 0x4159036D,
    104: 0x415D7D9B, 105: 0x41620575, 106: 0x41669B09, 107: 0x416B3E62,
    108: 0x416FEF8B, 109: 0x4174AE90, 110: 0x41797B7E, 114: 0x41869D94,
    115: 0x41892726, 116: 0x418BB7CC, 117: 0x418E4F8F, 118: 0x4190EE73,
    119: 0x4193947D, 120: 0x419641B4, 121: 0x4198F61D, 122: 0x419BB1BD,
    123: 0x419E749A, 124: 0x41A13EBB, 125: 0x41A41022, 126: 0x41A6E8D6,
    127: 0x41A9C8DD, 133: 0x41BBA3F6, 134: 0x41BEB7D3, 135: 0x41C1D32D,
    160: 0x420C9CF1, 161: 0x420E8F60, 162: 0x421085D1, 163: 0x42128044,
    188: 0x42492793, 189: 0x424B8D73, 190: 0x424DF792, 191: 0x425065F4,
    194: 0x4257CAB8, 195: 0x425A4A35, 196: 0x425CCDFD, 197: 0x425F5614,
    198: 0x4261E27A, 199: 0x42647334, 200: 0x42670842, 201: 0x4269A1A6,
    202: 0x426C3F63, 203: 0x426EE17C, 204: 0x427187F1, 205: 0x427432C4,
    206: 0x4276E1F9, 207: 0x42799590, 208: 0x427C4D8D, 209: 0x427F09EF,
    210: 0x4280E55F, 211: 0x428247FA, 212: 0x4283ACCC, 213: 0x428513D6,
    214: 0x42867D19, 215: 0x4287E895, 222: 0x4292179A, 223: 0x42939507,
    224: 0x429514B6, 225: 0x429696A7, 226: 0x42981ADE, 227: 0x4299A15A,
    228: 0x429B2A1C, 229: 0x429CB526, 230: 0x429E4277, 231: 0x429FD212,
    232: 0x42A163F8, 233: 0x42A2F828, 234: 0x42A48EA4, 235: 0x42A6276E,
    236: 0x42A7C285, 237: 0x42A95FEC, 238: 0x42AAFFA2, 239: 0x42ACA1A9,
    240: 0x42AE4602, 241: 0x42AFECAD, 243: 0x42B34100, 244: 0x42B4EEA8,
    245: 0x42B69EA9, 246: 0x42B850FF, 247: 0x42BA05B0, 248: 0x42BBBCB6,
    249: 0x42BD761A, 251: 0x42C0EFF4, 253: 0x42C4733F,
}


RGB_TO_XYZ = (
    (0.4124564, 0.3575761, 0.1804375),
    (0.2126729, 0.7151522, 0.0721750),
    (0.0193339, 0.1191920, 0.9503041),
)
XYZ_TO_RGB = (
    (3.2404542, -1.5371385, -0.4985314),
    (-0.9692660, 1.8760108, 0.0415560),
    (0.0556434, -0.2040259, 1.0572252),
)
WHITE_POINT = (95.0489, 100.0, 108.8840)
LAB_EPS = 0.008856
LAB_SLOPE = 7.787
LAB_OFFSET = 16.0 / 116.0


def _f32(value: float) -> float:
    return float(np.float32(value))


INV_WHITE = tuple(_f32(np.float32(1.0) / np.float32(w)) for w in WHITE_POINT)
TOE_SLOPE = tuple(_f32(np.float32(LAB_SLOPE) * np.float32(inv)) for inv in INV_WHITE)
THIRD = _f32(1.0 / 3.0)
INV_255 = _f32(np.float32(1.0) / np.float32(255.0))


def div(num: torch.Tensor, den: float) -> torch.Tensor:
    """`num / den` as a true IEEE division on every device."""
    return torch.div(num, torch.full((), den, dtype=num.dtype, device=num.device))


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """`a * b + c` rounded once to float32 (the product of two float32
    values is exact in float64)."""
    a = a.double()
    if not isinstance(c, torch.Tensor):
        return (a * (b.double() if isinstance(b, torch.Tensor) else b)).add_(c).float()
    if isinstance(b, torch.Tensor):
        return torch.addcmul(c.double(), a, b.double()).float()
    return torch.add(c.double(), a, alpha=b).float()


def gamma_table(device, folded: bool = False) -> torch.Tensor:
    """`[256]` float32 linear light (x100) of each u8 code."""
    bits = np.array(GAMMA_BITS, dtype=np.uint32)
    if folded:
        for code, value in FOLDED_GAMMA_DIFF.items():
            bits[code] = value
    return torch.from_numpy(bits.view(np.float32).copy()).to(device)


def _lab_f(t: torch.Tensor) -> torch.Tensor:
    return torch.where(t > LAB_EPS, torch.clamp(t, min=0.0) ** (1.0 / 3.0),
                       LAB_SLOPE * t + LAB_OFFSET)


def srgb8_to_lab(rgb8: torch.Tensor) -> torch.Tensor:
    """uint8 sRGB `[..., 3]` -> float32 Lab `[..., 3]`."""
    lin = gamma_table(rgb8.device)[rgb8.to(torch.int64)]
    r, g, b = lin[..., 0], lin[..., 1], lin[..., 2]
    x, y, z = (m[0] * r + m[1] * g + m[2] * b for m in RGB_TO_XYZ)
    fx = _lab_f(div(x, WHITE_POINT[0]))
    fy = _lab_f(div(y, WHITE_POINT[1]))
    fz = _lab_f(div(z, WHITE_POINT[2]))
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy), 200.0 * (fy - fz)], -1)


def srgb8_to_lab_folded(rgb8: torch.Tensor, inline: bool = False):
    """uint8 sRGB `[..., 3]` -> float32 Lab in the folded form the seeding
    reads (module docstring). With `inline`, also the float64 `[..., 3]` of
    L*, `500 * (fx - fy)` and `200 * (fy - fz)` unrounded: the first
    seeding map recomputes a pixel's a* and b* inline and rounds
    `500 * (fx - fy) - a_c` once."""
    device = rgb8.device
    lin = gamma_table(device, folded=True)[rgb8.to(torch.int64)]
    r, g, b = lin[..., 0:1], lin[..., 1:2], lin[..., 2:3]
    cols = [[_f32(row[i]) for row in RGB_TO_XYZ] for i in range(3)]
    m0 = torch.tensor(cols[0], dtype=torch.float64, device=device)
    m1 = torch.tensor(cols[1], dtype=torch.float32, device=device)
    m2 = torch.tensor(cols[2], dtype=torch.float64, device=device)
    inv = torch.tensor(INV_WHITE, dtype=torch.float32, device=device)
    slope = torch.tensor(TOE_SLOPE, dtype=torch.float64, device=device)
    x = fma(b, m2, fma(r, m0, g * m1))
    t = x * inv
    cube = torch.pow(torch.clamp(t, min=0.0).double(), THIRD).float()
    fx, fy, fz = torch.where(t > LAB_EPS, cube, fma(x, slope, _f32(LAB_OFFSET))).unbind(-1)
    dxy, dyz = fx - fy, fy - fz
    lab = torch.stack([fma(fy, 116.0, -16.0), dxy * 500.0, dyz * 200.0], -1)
    if not inline:
        return lab
    return lab, torch.stack([lab[..., 0].double(), dxy.double() * 500.0,
                             dyz.double() * 200.0], -1)


def _lab_f_inv(t: torch.Tensor) -> torch.Tensor:
    t3 = t * t * t
    return torch.where(t3 > LAB_EPS, t3, div(t - LAB_OFFSET, LAB_SLOPE))


def _linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    safe = torch.clamp(c, min=0.0)
    return torch.where(c > 0.0031308, 1.055 * safe ** (1.0 / 2.4) - 0.055, 12.92 * c)


def lab_to_srgb8(lab: torch.Tensor) -> torch.Tensor:
    """Lab `[..., 3]` -> uint8 sRGB, clipped, rounded half to even."""
    lab = lab.to(torch.float32)
    l, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
    fy = div(l + 16.0, 116.0)
    fx = div(a, 500.0) + fy
    fz = fy - div(b, 200.0)
    x = _lab_f_inv(fx) * (WHITE_POINT[0] / 100.0)
    y = _lab_f_inv(fy) * (WHITE_POINT[1] / 100.0)
    z = _lab_f_inv(fz) * (WHITE_POINT[2] / 100.0)
    lin = torch.stack([m[0] * x + m[1] * y + m[2] * z for m in XYZ_TO_RGB], -1)
    srgb = torch.clamp(_linear_to_srgb(lin), 0.0, 1.0)
    return torch.round(srgb * 255.0).to(torch.uint8)


def shrunk_size(width: int, height: int, max_size: int | None) -> tuple[int, int]:
    """`(width, height)` with the long side capped at `max_size` and the
    short side scaled with truncation (at least 1); None keeps the size."""
    if max_size is None or (width <= max_size and height <= max_size):
        return width, height
    if width > height:
        return max_size, max(int(height * max_size / width), 1)
    return max(int(width * max_size / height), 1), max_size


def _axis(n_out: int, n_in: int, device):
    k = float(np.float32(np.float32(1.0) / np.float32(n_out)) * np.float32(n_in))
    coord = (torch.arange(n_out, dtype=torch.float64, device=device) * k - 0.5).float()
    i0 = torch.floor(coord)
    frac = coord - i0
    lo = torch.clamp(i0.to(torch.int64), 0, n_in - 1)
    hi = torch.clamp(i0.to(torch.int64) + 1, 0, n_in - 1)
    return lo, hi, frac


def _blend(a: torch.Tensor, b: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    return fma(a, 1.0 - f, b * f)


def shrink_u8(image_u8: torch.Tensor, new_height: int, new_width: int) -> torch.Tensor:
    """uint8 `[..., H, W, C]` -> `[..., new_height, new_width, C]`, each
    leading frame shrunk alone (module docstring)."""
    h, w = image_u8.shape[-3], image_u8.shape[-2]
    y0, y1, fy = _axis(new_height, h, image_u8.device)
    x0, x1, fx = _axis(new_width, w, image_u8.device)
    top = image_u8[..., y0, :, :].to(torch.float32) * INV_255
    bot = image_u8[..., y1, :, :].to(torch.float32) * INV_255
    rows = _blend(top, bot, fy[:, None, None])
    out = _blend(rows[..., x0, :], rows[..., x1, :], fx[None, :, None])
    return torch.round(torch.clamp(out, 0.0, 1.0) * 255.0).to(torch.uint8)
