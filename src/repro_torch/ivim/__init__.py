"""The paper's IVIM task: physics, synthetic data, uIVIM-NET."""
