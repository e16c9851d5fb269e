from sirius_tpu_torch.config.schema import (
    Config,
    ControlConfig,
    IterativeSolverConfig,
    MixerConfig,
    ParametersConfig,
    SettingsConfig,
    UnitCellConfig,
    load_config,
)
