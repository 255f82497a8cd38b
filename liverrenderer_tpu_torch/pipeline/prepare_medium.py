"""The liver media's RGB coefficients from tissue parameters (counterpart
of liverrenderer_tpu/pipeline/prepare_medium.py; the reference's
liver/prepare_medium.py): the element models of `medium_models`
integrated over 360-710 nm and binned to the reference's RGB bands, giving
the sigma_* parameters that the liver, glissonCapsule and parenchyma
media take (the values baked into scenes/*/mitsuba3/scene.xml).
"""
from __future__ import annotations

from . import medium_models as mm

DEFAULTS = {
    # RendererSettings.yml "Glisson Capsule" + "Parenchyma" defaults
    "collagen_d": 3.5, "collagen_n_med": 1.35, "collagen_n_p": 1.5,
    "collagen_vf1": 0.949, "collagen_vf2": 0.810,
    "collagen_vf3": 0.001, "collagen_vf4": 0.007,
    "elastin_d": 0.5, "elastin_n_med": 1.33, "elastin_n_p": 1.534,
    "elastin_vf1": 0.051, "elastin_vf2": 0.189,
    "elastin_vf3": 0.254, "elastin_vf4": 0.087,
    "blood_vf": 0.004, "blood_St02": 0.9084, "blood_R": 0.004,
    "bile_vf": 0.0005,
    "water_vf": 0.7, "lipid_vf": 0.289,
    "hepatocity_vf": 0.8, "hepatocity_l_axis": 0.0020,
    "hepatocity_g_axis": 0.0030,
}


def compute_coefficients(settings: dict | None = None) -> dict:
    """The sigma_* parameters of the liver media, DEFAULTS updated by
    `settings`.

    Keys match the medium XML parameters (sigma_collagen{1-4}_{R,G,B},
    sigma_elastin{1-4}_{R,G,B}, sigma_blood, sigma_bile, sigma_lipid_water,
    sigma_hepatocity)."""
    s = dict(DEFAULTS)
    if settings:
        s.update(settings)

    out = {}
    coll = mm.CollagenElement()
    elas = mm.ElastinElement()
    for layer in range(1, 5):
        c = mm.rgb_bin(lambda lam: coll.coeff(
            s[f"collagen_vf{layer}"], s["collagen_d"], s["collagen_n_med"],
            s["collagen_n_p"], lam))
        e = mm.rgb_bin(lambda lam: elas.coeff(
            s[f"elastin_vf{layer}"], s["elastin_d"], s["elastin_n_med"],
            s["elastin_n_p"], lam))
        for i, ch in enumerate("RGB"):
            out[f"sigma_collagen{layer}_{ch}"] = float(c[i])
            out[f"sigma_elastin{layer}_{ch}"] = float(e[i])

    blood = mm.BloodElement(s["blood_vf"], s["blood_St02"], s["blood_R"])
    out["sigma_blood"] = [float(v) for v in mm.rgb_bin(blood.u_a)]
    bile = mm.BileElement(s["bile_vf"])
    out["sigma_bile"] = [float(v) for v in mm.rgb_bin(bile.u_a)]
    wl = mm.WaterLipidElement(s["water_vf"], s["lipid_vf"])
    out["sigma_lipid_water"] = [float(v) for v in mm.rgb_bin(wl.u_a)]
    out["sigma_hepatocity"] = float(mm.hepatocyte_ug(
        s["hepatocity_vf"], s["hepatocity_l_axis"], s["hepatocity_g_axis"]))
    return out
