from .fisher import fisher_info, clm_loss
