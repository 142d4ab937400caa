"""
List the encoder registry (counterpart of ``python -m uniception_tpu.models.encoders.list``): the JAX package's
table, each key with whether it has an intermediate-feature returner, whether the port builds it (or the ROADMAP
item that ports it), and its supported models.

    python -m uniception_tpu_torch.models.encoders.list
"""

from uniception_tpu_torch.models.encoders import ENCODER_CONFIGS, is_ported


def main():
    print("Available UniCeption encoders (uniception_tpu_torch):")
    for name, cfg in sorted(ENCODER_CONFIGS.items()):
        ifr = "yes" if "intermediate_feature_returner_class" in cfg else "no"
        port = "builds" if is_ported(name) else f"not yet ({cfg['class'].roadmap_item})"
        supported = ", ".join(cfg.get("supported_models", []))
        print(f"  {name:24s} IFR: {ifr:3s}  port: {port:26s} models: {supported}")


if __name__ == "__main__":
    main()
