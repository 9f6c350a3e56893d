"""DySkew core link: types, skew models and the adaptive state machine."""
